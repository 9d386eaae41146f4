"""The port's live weights: staging, the hot swap, version hygiene, the
rolling upgrade and the checkpoint watcher, against the JAX package.

Two weight versions of tiny Llama (fp32 compute) are published as the
port's npz checkpoints with their manifests.

- load_params_host and load_staged read what JAX's read (the same arrays
  and the same WeightVersion); a corrupt, truncated or manifest-less
  checkpoint is refused by both.
- A swap under load, on the JAX ServingEngine and the port's (a bf16-layout
  fp32 pool and an int8 pool): requests admitted before it give the
  version-N serial tokens, those after it the N+1 tokens, each the JAX
  engine's; the swap timeout cancels and the engine serves on.
- Version hygiene: the prefix index, retained prefixes and host-tier
  entries drop and the namespace is structural; adapters' generations
  bump and a stale stream fails typed.
- rolling_upgrade over two replicas: zero failed requests under load,
  every completion one version's tokens, the JAX router's verdicts on a
  good and a corrupt publish; the watcher's poll_once as JAX's.
- The server's PUT /admin swap (409 on a refusal), the SSE start frame's
  version, and the serving tool's --adapter_dir and --watch_checkpoints.
"""
import glob
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu import config as jconfig
from megatron_tpu.inference.generation import Generator as JGenerator
from megatron_tpu.models import language_model as jlm
from megatron_tpu.serving import CheckpointWatcher as JCheckpointWatcher
from megatron_tpu.serving import EngineRouter as JEngineRouter
from megatron_tpu.serving import RollingUpgradeError as JRollingUpgradeError
from megatron_tpu.serving import SamplingOptions as JSamplingOptions
from megatron_tpu.serving import ServingEngine as JServingEngine
from megatron_tpu.serving import WeightSwapError as JWeightSwapError
from megatron_tpu.serving import load_staged as j_load_staged
from megatron_tpu.serving.weights import stage_latest as j_stage_latest
from megatron_tpu.serving import adapters as jad
from megatron_tpu.training.checkpointing import _flatten
from megatron_tpu.training.checkpointing import \
    load_params_host as j_load_params_host
from megatron_tpu_torch import config as tconfig
from megatron_tpu_torch.config import ServingConfig
from megatron_tpu_torch.convert.from_jax import params_from_numpy
from megatron_tpu_torch.inference.generation import (Generator,
                                                     SamplingParams)
from megatron_tpu_torch.models.language_model import LanguageModel
from megatron_tpu_torch.serving import (SamplingOptions, ServingEngine,
                                        ServingMetrics)
from megatron_tpu_torch.serving.request import GenRequest
from megatron_tpu_torch.serving.router import (EngineRouter,
                                               RollingUpgradeError)
from megatron_tpu_torch.serving.weights import (CheckpointWatcher,
                                                WeightSwapError,
                                                WeightVersion, host_params,
                                                load_staged, place_params,
                                                stage_latest)
from megatron_tpu_torch.training import checkpointing as t_ckpt
from megatron_tpu_torch.training.train_step import TrainState

torch.set_num_threads(2)
TOL = 1e-4
GREEDY = SamplingOptions(temperature=0.0)
JGREEDY = JSamplingOptions(temperature=0.0)
PROMPTS = [[5, 17, 3, 42], [7, 8, 9], [11, 12, 13, 14, 15]]
KW = dict(attention_impl="flash", compute_dtype="float32")


def _model(seed):
    jcfg = jconfig.llama2_config("tiny", **KW)
    tcfg = tconfig.llama2_config("tiny", **KW)
    params = jlm.model_init(jax.random.PRNGKey(seed), jcfg)
    model = LanguageModel.from_state_dict(
        tcfg, params_from_numpy(_flatten(params), tcfg, device="cpu"))
    return jcfg, params, tcfg, model


def _publish(root, model, tcfg, iteration):
    return t_ckpt.save_checkpoint(
        str(root), TrainState(params=model, opt_state=None,
                              iteration=iteration),
        tconfig.MegatronConfig(model=tcfg), iteration)


@pytest.fixture(scope="module")
def versions(tmp_path_factory):
    jcfg, p1, tcfg, m1 = _model(0)
    _, p2, _, m2 = _model(1)
    root = tmp_path_factory.mktemp("ckpts")
    d2 = _publish(root, m2, tcfg, 2)
    return dict(jcfg=jcfg, tcfg=tcfg, p1=p1, p2=p2, m1=m1, m2=m2,
                root=str(root), d2=d2)


def _corrupt_payload(ckpt_dir):
    """Flip one byte of the largest payload file."""
    files = [p for p in glob.glob(os.path.join(ckpt_dir, "**"),
                                  recursive=True)
             if os.path.isfile(p) and not p.endswith("manifest.json")]
    target = max(files, key=os.path.getsize)
    with open(target, "r+b") as f:
        b0 = f.read(1)
        f.seek(0)
        f.write(bytes([b0[0] ^ 0xFF]))
    return target


def _gen(v, which, eos=-1, kv=torch.float32):
    return Generator(v[which], v["tcfg"], eos_id=eos, pad_id=0,
                     kv_cache_dtype=kv, device="cpu")


def _oracle(gen, prompt, n):
    t, lens, _ = gen.generate([list(prompt)], n,
                              sampling=SamplingParams(temperature=0.0))
    return t[0, :lens[0]].tolist()


def test_staging_matches_jax_and_refuses_bad_checkpoints(versions,
                                                         tmp_path):
    v = versions
    got = t_ckpt.load_params_host(v["d2"], v["m1"])
    want = _flatten(j_load_params_host(v["d2"], v["p1"]))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    ts, js = load_staged(v["d2"], v["m1"]), j_load_staged(v["d2"], v["p1"])
    assert ts.version.label == js.version.label
    assert ts.version == WeightVersion(2, js.version.digest)
    assert ts.nbytes == sum(a.nbytes for a in got.values())
    # a different model's checkpoint is refused, not reshaped
    small = tconfig.llama2_config("tiny", num_layers=1, **KW)
    with pytest.raises(WeightSwapError, match="staging"):
        load_staged(v["d2"], LanguageModel(small, device="cpu"))
    d = _publish(tmp_path, v["m2"], v["tcfg"], 5)
    target = _corrupt_payload(d)
    for loader, err, ex in ((load_staged, WeightSwapError, v["m1"]),
                            (j_load_staged, JWeightSwapError, v["p1"])):
        with pytest.raises(err, match="manifest gate"):
            loader(d, ex)
    with open(target, "r+b") as f:
        f.truncate(os.path.getsize(target) // 2)
    for loader, err, ex in ((load_staged, WeightSwapError, v["m1"]),
                            (j_load_staged, JWeightSwapError, v["p1"])):
        with pytest.raises(err, match="manifest gate"):
            loader(d, ex)
    d6 = _publish(tmp_path, v["m2"], v["tcfg"], 6)
    os.remove(os.path.join(d6, "manifest.json"))
    for loader, err, ex in ((load_staged, WeightSwapError, v["m1"]),
                            (j_load_staged, JWeightSwapError, v["p1"])):
        with pytest.raises(err, match="manifest"):
            loader(d6, ex)
        assert loader(d6, ex, require_manifest=False).version.digest == \
            "unverified"
    # startup staging: the tracker's manifest-less 6 is admitted; with 6
    # gone the corrupt 5 is refused and nothing is left
    assert stage_latest(str(tmp_path), v["m1"]).version.iteration == 6
    assert j_stage_latest(str(tmp_path), v["p1"]).version.iteration == 6
    # an orbax checkpoint is JAX's alone
    os.makedirs(os.path.join(d6, "state"))
    with pytest.raises(NotImplementedError, match="orbax"):
        t_ckpt.load_params_host(d6, v["m1"])
    with pytest.raises(WeightSwapError, match="no stageable"):
        stage_latest(str(tmp_path), v["m1"])
    # host_params holds what the checkpoint holds
    host = host_params(v["m2"])
    assert set(host) == set(got)
    for k in host:
        np.testing.assert_array_equal(host[k], got[k])
    assert not np.shares_memory(
        host["embedding/word_embeddings"],
        v["m2"].embedding["word_embeddings"].detach().numpy())


def test_place_params_shares_one_copy_and_keeps_dtypes(versions):
    v = versions
    staged = load_staged(v["d2"], v["m1"])
    bf16 = LanguageModel.from_state_dict(v["tcfg"], {
        k: t.to(torch.bfloat16) for k, t in v["m1"].state_dict().items()})
    placed = place_params(staged, bf16, v["tcfg"], "cpu")
    assert placed is place_params(staged, bf16, v["tcfg"], "cpu")
    assert isinstance(placed, LanguageModel)
    assert placed.transformer["attention"]["wq"].dtype == torch.bfloat16
    torch.testing.assert_close(
        placed.transformer["attention"]["wq"],
        v["m2"].transformer["attention"]["wq"].to(torch.bfloat16),
        rtol=0, atol=0)
    from megatron_tpu_torch.ops.quantized import W8, quantize_weights
    w8 = quantize_weights(v["m1"])
    placed = place_params(load_staged(v["d2"], w8), w8, v["tcfg"], "cpu")
    ref = quantize_weights(v["m2"])
    got_w = placed["transformer"]["attention"]["wq"]
    assert isinstance(got_w, W8)
    torch.testing.assert_close(got_w.q, ref["transformer"]["attention"]
                               ["wq"].q, rtol=0, atol=0)


def _swap_under_load(eng, d2, submit):
    """Batch A admitted at N straddles the swap; batch B is admitted after
    the swap returned."""
    reqs_a = [submit(p, 20, i) for i, p in enumerate(PROMPTS)]
    t0 = time.monotonic()
    while not any(r.generated for r in reqs_a):
        assert time.monotonic() - t0 < 120
        time.sleep(0.005)
    version = eng.swap_weights(d2, timeout=300)
    reqs_b = [submit(p, 8, 100 + i) for i, p in enumerate(PROMPTS)]
    return version, [r.result(timeout=300) for r in reqs_a + reqs_b]


@pytest.mark.parametrize("kv", [None, "int8"])
def test_swap_under_load_matches_jax(versions, kv):
    v = versions
    kw = dict(num_slots=3, max_queue=32, max_len=64,
              enable_prefix_cache=True, kv_block_size=16, kv_dtype=kv)
    jeng = JServingEngine(JGenerator(v["p1"], v["jcfg"], eos_id=-1, pad_id=0,
                                     kv_cache_dtype=jnp.float32),
                          jconfig.ServingConfig(**kw))
    try:
        jv, want = _swap_under_load(jeng, v["d2"], lambda p, n, s: (
            jeng.submit(p, n, JGREEDY, seed=s)))
    finally:
        jeng.close()
    gen1 = _gen(v, "m1")
    with ServingEngine(gen1, ServingConfig(**kw), device="cpu") as eng:
        version, got = _swap_under_load(eng, v["d2"], lambda p, n, s: (
            eng.submit(p, n, GREEDY, seed=s)))
        snap = eng.metrics.snapshot()
        h = eng.health()
        assert eng.gen is not gen1 and gen1.params is v["m1"]
    assert version.label == jv.label and version.iteration == 2
    assert snap["weight_swaps"] == 1 and snap["weight_swap_failures"] == 0
    assert snap["weight_version"] == 2.0
    assert h["weight_version"] == version.label
    assert h["weight_iteration"] == 2 and not h["weight_swap_pending"]
    for (gt, glp), (wt, wlp) in zip(got, want):
        assert gt == wt
        np.testing.assert_allclose(glp, wlp, rtol=TOL, atol=TOL)
    if kv is None:
        gen2 = _gen(v, "m2")
        for i, p in enumerate(PROMPTS):
            assert got[i][0] == _oracle(gen1, p, 20)
            assert got[3 + i][0] == _oracle(gen2, p, 8)


def test_swap_refusals_and_timeout_keep_serving(versions, tmp_path):
    v = versions
    d = _publish(tmp_path, v["m2"], v["tcfg"], 5)
    gen1 = _gen(v, "m1")
    with ServingEngine(gen1, ServingConfig(num_slots=2, max_len=64),
                       device="cpu") as eng:
        target = _corrupt_payload(d)
        with pytest.raises(WeightSwapError):
            eng.swap_weights(d, timeout=60)
        with open(target, "r+b") as f:
            f.truncate(max(os.path.getsize(target) // 2, 1))
        with pytest.raises(WeightSwapError):
            eng.swap_weights(d, timeout=60)
        os.remove(os.path.join(d, "manifest.json"))
        with pytest.raises(WeightSwapError):
            eng.swap_weights(d, timeout=60)
        long_req = eng.submit(PROMPTS[0], 40, GREEDY)
        t0 = time.monotonic()
        while not long_req.generated:
            assert time.monotonic() - t0 < 120
            time.sleep(0.005)
        with pytest.raises(WeightSwapError, match="timed out"):
            eng.swap_weights(v["d2"], timeout=0.0)
        assert long_req.result(timeout=300)[0] == _oracle(gen1, PROMPTS[0],
                                                          40)
        snap = eng.metrics.snapshot()
        assert snap["weight_swap_failures"] == 4
        assert snap["weight_swaps"] == 0 and snap["weight_version"] == 0.0
        assert eng.health()["weight_version"] == "unversioned"
        r = eng.submit(PROMPTS[1], 4, GREEDY)
        assert r.result(timeout=300)[0] == _oracle(gen1, PROMPTS[1], 4)


def test_version_hygiene(versions):
    v = versions
    serving = ServingConfig(num_slots=2, max_queue=16, max_len=64,
                            enable_prefix_cache=True, kv_block_size=16,
                            host_kv_bytes=1 << 22)
    prompt = list(range(2, 22))
    with ServingEngine(_gen(v, "m1"), serving, device="cpu") as eng:
        eng.generate(prompt, 4, GREEDY)
        eng.generate(prompt + [60, 61], 4, GREEDY)
        assert eng.pool.retained_count() >= 1
        assert eng.prefix_peek(prompt + [90]) >= 16
        eng.swap_weights(v["d2"], timeout=300)
        assert eng.pool.retained_count() == 0
        assert len(eng._host_tier) == 0
        assert eng.prefix_peek(prompt + [90]) == 0
        hits = eng.metrics.snapshot()["prefix_hits"]
        toks, _ = eng.generate(prompt + [90, 91], 6, GREEDY)
        assert toks == _oracle(_gen(v, "m2"), prompt + [90, 91], 6)
        assert eng.metrics.snapshot()["prefix_hits"] == hits
    with ServingEngine(_gen(v, "m1"), serving, device="cpu",
                       start=False) as eng:
        tokens = list(range(2, 22))
        eng._index.insert(0, tokens, namespace=eng._ns(None))
        assert eng._lookup_prefix(tokens + [50])[1] >= 16
        eng._weight_gen += 1  # what a swap does
        assert eng._lookup_prefix(tokens + [50]) == (None, 0)


def test_adapter_generations_bump_at_swap(versions):
    v = versions
    f = jad.random_adapter_factors(v["jcfg"], 4, 1)
    serving = ServingConfig(num_slots=2, max_len=64, adapter_slots=2,
                            adapter_rank=4)
    with ServingEngine(_gen(v, "m1"), serving, device="cpu") as eng:
        eng.register_adapter("tenant", factors=f, rank=4, alpha=1.0)
        eng.generate(PROMPTS[0], 4, GREEDY, adapter_id="tenant")
        assert eng.adapter_peek("tenant") == 2
        ns = eng.adapters.namespace("tenant")
        eng.swap_weights(v["d2"], timeout=300)
        assert eng.adapters.namespace("tenant") != ns
        assert eng.adapter_peek("tenant") == 1  # unmapped, still known
        stale = GenRequest(PROMPTS[0], 4, GREEDY, adapter_id="tenant")
        stale.adapter_ns = ns
        assert eng._acquire_adapter(stale) == "failed"
        assert stale.done() and "re-registered" in stale.error
        toks, _ = eng.generate(PROMPTS[0], 4, GREEDY, adapter_id="tenant")
        assert toks and eng.adapter_peek("tenant") == 2


def test_rolling_upgrade_under_load(versions):
    v = versions
    gen1, gen2 = _gen(v, "m1"), _gen(v, "m2")
    serving = ServingConfig(num_slots=2, max_queue=64, max_len=64)
    engines = [ServingEngine(gen1, serving, device="cpu") for _ in range(2)]
    router = EngineRouter(engines, max_retries=2, heartbeat_timeout_s=3.0,
                          probe_backoff_s=0.2)
    results, stop, lock = [], threading.Event(), threading.Lock()

    def worker(wid):
        i = 0
        while not stop.is_set():
            p = [3 + (wid + i) % 5, 7, 11]
            try:
                toks, _ = router.submit(p, 6, GREEDY).result(timeout=120)
                with lock:
                    results.append((p, toks, None))
            except Exception as e:  # noqa: BLE001 — counted below
                with lock:
                    results.append((p, None, e))
            i += 1

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(3)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.3)
        version = router.rolling_upgrade(v["d2"], swap_timeout_s=300)
        time.sleep(0.3)
    finally:
        stop.set()
        for t in threads:
            t.join()
    try:
        assert version.iteration == 2
        assert not [e for *_, e in results if e is not None]
        assert len(results) >= 4
        for p, toks, _ in results:
            assert toks in (_oracle(gen1, p, 6), _oracle(gen2, p, 6)), p
        r = router.submit([9, 9, 8], 6, GREEDY).result(timeout=120)
        assert r[0] == _oracle(gen2, [9, 9, 8], 6)
        snap = router.aggregate_snapshot()
        assert snap["rolling_upgrades"] == 1 and snap["weight_swaps"] == 2
        assert snap["weight_version_min"] == snap["weight_version_max"] \
            == snap["weight_version"] == 2.0
        h = router.health()
        assert h["state"] == "running" and h["replicas_up"] == 2
        assert all(r["weight_version"].startswith("2:")
                   for r in h["replicas"])
        # both replicas swapped to one placed copy of the new weights
        assert engines[0].gen.params is engines[1].gen.params
        assert gen1.params is v["m1"]
    finally:
        router.close()


def _fleet_verdicts(make_engine, make_router, d_good, d_bad, submit,
                    err_type):
    """A good publish, then a corrupt one, on a two-replica router:
    (upgrade iteration, refused?, counters, next request's tokens)."""
    engines = [make_engine() for _ in range(2)]
    router = make_router(engines)
    try:
        first = router.rolling_upgrade(d_good, swap_timeout_s=120)
        refused = False
        try:
            router.rolling_upgrade(d_bad, swap_timeout_s=60)
        except err_type:
            refused = True
        snap = router.aggregate_snapshot()
        counters = tuple(snap[k] for k in ("rolling_upgrades",
                                           "weight_swaps",
                                           "weight_swap_failures",
                                           "weight_version"))
        toks = submit(router, PROMPTS[1], 4)
        return first.iteration, refused, counters, toks
    finally:
        router.close()


def test_rolling_upgrade_verdicts_match_jax(versions, tmp_path):
    v = versions
    d7 = _publish(tmp_path, v["m1"], v["tcfg"], 7)
    _corrupt_payload(d7)
    sc = dict(num_slots=2, max_queue=32, max_len=64)
    jgen = JGenerator(v["p1"], v["jcfg"], eos_id=-1, pad_id=0,
                      kv_cache_dtype=jnp.float32)
    want = _fleet_verdicts(
        lambda: JServingEngine(jgen, jconfig.ServingConfig(**sc)),
        lambda engines: JEngineRouter(engines, heartbeat_timeout_s=3.0,
                                      probe_backoff_s=0.05),
        v["d2"], d7,
        lambda r, p, n: r.submit(p, n, JGREEDY).result(timeout=120)[0],
        JRollingUpgradeError)
    gen1 = _gen(v, "m1")
    got = _fleet_verdicts(
        lambda: ServingEngine(gen1, ServingConfig(**sc), device="cpu"),
        lambda engines: EngineRouter(engines, heartbeat_timeout_s=3.0,
                                     probe_backoff_s=0.05),
        v["d2"], d7,
        lambda r, p, n: r.submit(p, n, GREEDY).result(timeout=120)[0],
        RollingUpgradeError)
    assert got == want
    assert got[:3] == (2, True, (1.0, 2.0, 1.0, 2.0))


def test_watcher_poll_once_matches_jax(versions, tmp_path):
    """poll_once on a root that publishes nothing, then 2, a corrupt 3
    (refused once, not retried on the same tag), then 4."""
    v = versions

    def drive(eng, watcher_cls, root):
        w = watcher_cls(eng, root, interval_s=0.05)
        out = [w.poll_once()]
        _publish(root, v["m2"], v["tcfg"], 2)
        out += [w.poll_once(), w.applied, eng.health()["weight_iteration"]]
        _corrupt_payload(_publish(root, v["m1"], v["tcfg"], 3))
        out += [w.poll_once(), w.failures, w.poll_once(), w.failures,
                eng.health()["weight_iteration"]]
        _publish(root, v["m2"], v["tcfg"], 4)
        out += [w.poll_once(), eng.health()["weight_iteration"],
                eng.metrics.snapshot()["weight_swap_failures"]]
        return out

    sc = dict(num_slots=2, max_queue=16, max_len=64)
    jeng = JServingEngine(JGenerator(v["p1"], v["jcfg"], eos_id=-1,
                                     pad_id=0), jconfig.ServingConfig(**sc))
    try:
        want = drive(jeng, JCheckpointWatcher, str(tmp_path / "j"))
    finally:
        jeng.close()
    with ServingEngine(_gen(v, "m1"), ServingConfig(**sc),
                       device="cpu") as eng:
        got = drive(eng, CheckpointWatcher, str(tmp_path / "t"))
        toks, _ = eng.generate(PROMPTS[0], 4, GREEDY)
        assert toks == _oracle(_gen(v, "m2"), PROMPTS[0], 4)
    assert got == want == [False, True, "2", 2, False, 1, False, 1, 2,
                           True, 4, 1.0]


class _Tok:
    eod = 0

    def tokenize(self, text):
        return [3 + (ord(c) % 50) for c in text]

    def detokenize(self, ids):
        return "".join(chr(97 + i % 26) for i in ids)


def test_server_admin_swap_and_stream_version(versions, tmp_path):
    from megatron_tpu_torch.inference.server import MegatronServer
    v = versions
    d5 = _publish(tmp_path, v["m1"], v["tcfg"], 5)
    _corrupt_payload(d5)
    for replicas in (1, 2):
        server = MegatronServer(_gen(v, "m1"), _Tok(),
                                serving=ServingConfig(
                                    num_slots=2, max_len=64,
                                    num_replicas=replicas),
                                device="cpu")
        try:
            assert server.handle_admin({"op": "swap_weights",
                                        "ckpt_dir": d5})[0] == 409
            base = {"prompts": ["hi"], "tokens_to_generate": 3,
                    "temperature": 0.0}
            assert server.handle(dict(base, serial=True))[0] == 200
            status, body = server.handle_admin(
                {"op": "swap_weights", "ckpt_dir": v["d2"]})
            assert status == 200 and body["iteration"] == 2
            assert server.handle(dict(base, serial=True))[0] == 409
            assert server.handle(dict(base, beam_width=2))[0] == 409
            assert server.handle(base)[1]["segments"][0] == _oracle(
                _gen(v, "m2"), _Tok().tokenize("hi"), 3)
            status, frames = server.handle(dict(base, stream=True))
            start = next(iter(frames))
            assert f'"weight_version": "{body["label"]}"' in start
            frames.close()
            snap = server.metrics_snapshot()
            assert snap["weight_swaps"] == replicas
            assert snap["weight_swap_failures"] >= 1
            assert server.healthz()[0] == 200
            assert server.handle_admin({"op": "drain", "timeout": 30}) == \
                (200, {"drained": True})
        finally:
            server.close()


def test_serving_tool_adapter_dir_and_watcher(versions, tmp_path):
    """--adapter_dir registers every export (adapter_id = file stem) and
    --watch_checkpoints swaps the served root's next publish; the server
    starts knowing the version it loaded."""
    from megatron_tpu_torch.tools import run_text_generation_server as srv
    from megatron_tpu_torch.tools import synthetic_corpus as sc
    from megatron_tpu_torch.training.lora import export_adapter
    v = versions
    cfg = tconfig.llama2_config("tiny", vocab_size=300, **KW)
    m1, m2 = (LanguageModel(cfg, device="cpu", seed=s) for s in (1, 2))
    root = tmp_path / "root"
    _publish(root, m1, cfg, 1)
    adir = tmp_path / "adapters"
    adir.mkdir()
    for name, seed in (("alpha", 1), ("beta", 2)):
        export_adapter(str(adir / f"{name}.npz"),
                       jad.random_adapter_factors(v["jcfg"], 2, seed),
                       rank=2, alpha=4.0)
    vocab, merges = sc.write_gpt2_vocab(str(tmp_path), 300)
    server, _ = srv.build_server(
        ["--load", str(root), "--tokenizer_type", "GPT2BPETokenizer",
         "--vocab_file", vocab, "--merge_file", merges, "--num_slots", "2",
         "--serving_max_len", "64", "--adapter_slots", "2",
         "--adapter_rank", "4", "--adapter_dir", str(adir),
         "--watch_checkpoints", "--watch_interval_s", "0.05"], device="cpu")
    try:
        assert server.engine.weight_version.iteration == 1
        assert sorted(server.engine.adapters.ids()) == ["alpha", "beta"]
        status, _ = server.handle({"prompts": ["hello"],
                                   "tokens_to_generate": 2,
                                   "temperature": 0.0, "adapter_id": "beta"})
        assert status == 200
        assert server._watcher.applied == "1"  # no swap to what it loaded
        _publish(root, m2, cfg, 2)
        t0 = time.monotonic()
        while server.engine.health()["weight_iteration"] != 2:
            assert time.monotonic() - t0 < 60
            time.sleep(0.02)
    finally:
        server.close()
    with pytest.raises(SystemExit):
        srv.build_server(["--load", str(root), "--adapter_dir", str(adir)],
                         device="cpu")


def test_fresh_snapshot_carries_the_new_keys():
    snap = ServingMetrics().snapshot()
    for key in ("adapter_loads", "adapter_evictions", "adapter_host_hits",
                "adapter_host_checksum_misses", "weight_swaps",
                "weight_swap_failures", "rolling_upgrades",
                "active_adapters", "weight_version"):
        assert snap[key] == 0.0, key
