"""The port's continuous-batching ServingEngine.

- Against the JAX package's ServingEngine, both block-native
  (ServingConfig(num_slots=3, kv_block_size=16, block_native_attn=True)),
  on the same weights: tiny Llama and Falcon with the flash prefill and fp32
  compute; five prompts through three slots, so slots are reused and
  prompts cross block boundaries while they decode. Greedy tokens exact,
  logprobs within 1e-4.
- Inside the port: the block-native engine, the whole-region engine (dot
  decode path) and the serial Generator give the same greedy tokens; a
  seeded stochastic engine request equals the serial batch-1 generate; K=1
  and K=3 decode_sync_interval give the same streams (fp32 KV cache, so the
  paths see the same values).
- Failure paths: cancel, deadline, a full queue, a crashed step; and the
  per-row sampler against the reference's.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu import config as jconfig
from megatron_tpu.inference import sampling as jsampling
from megatron_tpu.inference.generation import Generator as JGenerator
from megatron_tpu.models import language_model as jlm
from megatron_tpu.serving import SamplingOptions as JSamplingOptions
from megatron_tpu.serving import ServingEngine as JServingEngine
from megatron_tpu.training.checkpointing import _flatten
from megatron_tpu_torch import config as tconfig
from megatron_tpu_torch.config import ServingConfig
from megatron_tpu_torch.inference import sampling as tsampling
from megatron_tpu_torch.inference.generation import Generator, SamplingParams
from megatron_tpu_torch.convert.from_jax import params_from_numpy
from megatron_tpu_torch.models.language_model import LanguageModel
from megatron_tpu_torch.serving import (DeadlineExceededError,
                                        EngineUnhealthyError, QueueFullError,
                                        RequestFailedError, RequestState,
                                        SamplingOptions,
                                        ServiceUnavailableError,
                                        ServingEngine)

torch.set_num_threads(2)
TOL = 1e-4
PRESETS = {"llama": "llama2_config", "falcon": "falcon_config"}
# lengths 3, 14, 20, 33, 9: 14 and 33 cross a 16-token block boundary
# while they decode 10 tokens
PROMPTS = [[5, 17, 3], list(range(30, 44)), list(range(100, 120)),
           list(range(200, 233)), [7, 8, 9, 10, 11, 12, 13, 14, 15]]
NEW = 10
BLOCK = dict(num_slots=3, kv_block_size=16, block_native_attn=True,
             max_len=128)


def _models(name):
    fn = PRESETS[name]
    kw = dict(attention_impl="flash", compute_dtype="float32")
    jcfg = getattr(jconfig, fn)("tiny", **kw)
    tcfg = getattr(tconfig, fn)("tiny", **kw)
    params = jlm.model_init(jax.random.PRNGKey(0), jcfg)
    model = LanguageModel.from_state_dict(
        tcfg, params_from_numpy(_flatten(params), tcfg, device="cpu"))
    return jcfg, params, tcfg, model


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_block_native_engine_matches_jax_engine(name):
    jcfg, params, tcfg, model = _models(name)
    jeng = JServingEngine(JGenerator(params, jcfg, eos_id=0, pad_id=0),
                          jconfig.ServingConfig(**BLOCK))
    try:
        reqs = [jeng.submit(p, NEW, JSamplingOptions(temperature=0.0))
                for p in PROMPTS]
        want = [r.result(timeout=600) for r in reqs]
    finally:
        jeng.close()
    gen = Generator(model, tcfg, eos_id=0, pad_id=0, device="cpu")
    with ServingEngine(gen, ServingConfig(**BLOCK), device="cpu") as eng:
        reqs = [eng.submit(p, NEW, SamplingOptions(temperature=0.0))
                for p in PROMPTS]
        got = [r.result(timeout=600) for r in reqs]
        snap = eng.metrics.snapshot()
    for (gt, glp), (wt, wlp) in zip(got, want):
        assert gt == wt
        np.testing.assert_allclose(glp, wlp, rtol=TOL, atol=TOL)
    assert snap["kv_attn_path"] == 2.0
    assert snap["requests_completed"] == len(PROMPTS)


@pytest.fixture(scope="module")
def port_gen():
    _, _, tcfg, model = _models("llama")
    return Generator(model, tcfg, eos_id=0, pad_id=0, device="cpu",
                     kv_cache_dtype=torch.float32)


def _run(gen, serving, sampling, seeds=None):
    with ServingEngine(gen, serving, device="cpu") as eng:
        reqs = [eng.submit(p, NEW, sampling,
                           seed=0 if seeds is None else seeds[i])
                for i, p in enumerate(PROMPTS)]
        return [r.result(timeout=120)[0] for r in reqs]


def _serial(gen, sp, seeds=None):
    out = []
    for i, p in enumerate(PROMPTS):
        toks, lens, _ = gen.generate([p], NEW, sampling=sp,
                                     seed=0 if seeds is None else seeds[i])
        out.append(toks[0, :lens[0]].tolist())
    return out


def test_block_region_and_serial_greedy_agree(port_gen):
    greedy = SamplingOptions(temperature=0.0)
    block = _run(port_gen, ServingConfig(**BLOCK), greedy)
    region = _run(port_gen, ServingConfig(num_slots=3, max_len=128), greedy)
    assert block == region == _serial(port_gen,
                                      SamplingParams(temperature=0.0))


@pytest.mark.parametrize("sync", [1, 3])
def test_seeded_engine_equals_serial_batch_1(port_gen, sync):
    sp = SamplingOptions(temperature=0.8, top_k=40, top_p=0.9)
    seeds = [11 + i for i in range(len(PROMPTS))]
    got = _run(port_gen, ServingConfig(**BLOCK, decode_sync_interval=sync),
               sp, seeds)
    assert got == _serial(port_gen, SamplingParams(0.8, 40, 0.9), seeds)


def test_failure_paths(port_gen):
    # a full queue: the engine is not started, so nothing leaves the queue
    eng = ServingEngine(port_gen, ServingConfig(num_slots=1, max_queue=2,
                                                max_len=128),
                        device="cpu", start=False)
    queued = [eng.submit([5, 6, 7], 4) for _ in range(2)]
    with pytest.raises(QueueFullError) as info:
        eng.submit([5, 6, 7], 4)
    assert info.value.retry_after >= 1 and info.value.queue_depth == 2
    eng.cancel(queued[0])
    assert queued[0].state is RequestState.FAILED
    with pytest.raises(RequestFailedError, match="cancelled"):
        queued[0].result(timeout=1)
    eng.close()
    assert queued[1].state is RequestState.FAILED

    with ServingEngine(port_gen, ServingConfig(**BLOCK),
                       device="cpu") as eng:
        running = eng.submit([5, 6, 7], 100, seed=1)
        while not running.generated:
            time.sleep(0.01)
        eng.cancel(running)
        with pytest.raises(RequestFailedError, match="cancelled"):
            running.result(timeout=60)
        assert running.state is RequestState.FAILED
        late = eng.submit([5, 6, 7], 100, seed=2, deadline_s=0.05)
        with pytest.raises(DeadlineExceededError):
            late.result(timeout=60)
        assert late.state is RequestState.FAILED
        snap = eng.metrics.snapshot()
        assert snap["requests_cancelled"] == 1
        assert snap["requests_expired"] == 1

    # drain: slotted requests finish, queued ones fail retryably, new
    # submits are refused
    eng = ServingEngine(port_gen, ServingConfig(num_slots=1, max_len=128),
                        device="cpu")
    running = eng.submit([5, 6, 7], 40, seed=3)
    while not running.generated:
        time.sleep(0.01)
    queued = eng.submit([8, 9], 4)
    assert eng.drain(timeout=60)
    running.result(timeout=1)
    assert running.state is RequestState.FINISHED
    with pytest.raises(ServiceUnavailableError):
        queued.result(timeout=1)
    with pytest.raises(QueueFullError, match="draining"):
        eng.submit([5, 6], 2)
    eng.close()


def test_crashed_step_fails_requests_and_marks_unhealthy(port_gen):
    # no restart budget: the first crash opens the circuit breaker
    with ServingEngine(port_gen, ServingConfig(**BLOCK,
                                               max_engine_restarts=0),
                       device="cpu") as eng:
        def boom():
            raise RuntimeError("injected step failure")
        eng._decode_fn = boom
        req = eng.submit([5, 6, 7], 4)
        with pytest.raises(RequestFailedError, match="injected"):
            req.result(timeout=60)
        assert eng.health()["healthy"] is False
        with pytest.raises(EngineUnhealthyError):
            eng.submit([5, 6, 7], 4)


def test_later_slice_fields_raise():
    """The serving topology waits for a later slice; the remote-replica
    fields, ported since, validate."""
    for kw in (dict(disaggregate_prefill=True), dict(serving_tp=2)):
        with pytest.raises(NotImplementedError):
            ServingConfig(**kw).validate()
    for kw in (dict(fleet="127.0.0.1:1"), dict(replica_mode=True)):
        cfg = ServingConfig(**kw)
        assert cfg.validate() is cfg
    with pytest.raises(ValueError, match="divide"):
        ServingConfig(kv_block_size=24, block_native_attn=True,
                      max_len=128).validate(tconfig.llama2_config("tiny"))


def test_row_filters_and_greedy_rows_match_jax():
    rs = np.random.RandomState(3)
    logits = 3 * rs.standard_normal((4, 64)).astype(np.float32)
    ks = np.array([0, 1, 5, 50], np.int32)
    ps = np.array([0.0, 0.3, 0.9, 1.0], np.float32)
    np.testing.assert_array_equal(
        tsampling._top_k_filter_rows(torch.from_numpy(logits),
                                     torch.from_numpy(ks)).numpy(),
        np.asarray(jsampling._top_k_filter_rows(jnp.asarray(logits),
                                                jnp.asarray(ks))))
    np.testing.assert_array_equal(
        tsampling._top_p_filter_rows(torch.from_numpy(logits),
                                     torch.from_numpy(ps)).numpy(),
        np.asarray(jsampling._top_p_filter_rows(jnp.asarray(logits),
                                                jnp.asarray(ps))))
    temps = np.array([0.0, 0.0, 1.0, 0.7], np.float32)
    mask = np.ones((4, 64), bool)
    mask[0, np.argmax(logits[0])] = False
    mask[3] = False
    gens = [None, None, torch.Generator().manual_seed(1),
            torch.Generator().manual_seed(2)]
    got = tsampling.sample_batched(
        gens, torch.from_numpy(logits), temperature=torch.from_numpy(temps),
        top_k=torch.from_numpy(ks), top_p=torch.from_numpy(ps),
        vocab_size=60, mask=torch.from_numpy(mask)).numpy()
    want = np.asarray(jsampling.sample_batched(
        jax.random.split(jax.random.PRNGKey(0), 4), jnp.asarray(logits),
        temperature=jnp.asarray(temps), top_k=jnp.asarray(ks),
        top_p=jnp.asarray(ps), vocab_size=60, mask=jnp.asarray(mask)))
    # greedy rows (masked argmax) and the all-masked sentinel match;
    # stochastic draws differ in bits, so only their range is checked
    np.testing.assert_array_equal(got[[0, 1, 3]], want[[0, 1, 3]])
    assert got[3] == -1 and 0 <= got[2] < 60


def test_filters_passed_as_none_draw_the_same_tokens():
    # a knob of None (the filter off on every row, its sort skipped) draws
    # what zeros draw, and a row whose filter is off keeps its logits
    # exactly while the filter runs for other rows
    logits = torch.from_numpy(
        3 * np.random.RandomState(5).standard_normal((3, 64)).astype(
            np.float32))
    temps = torch.tensor([0.8, 1.0, 0.5])

    def draw(top_k, top_p):
        gens = [torch.Generator().manual_seed(s) for s in (1, 2, 3)]
        return tsampling.sample_batched(gens, logits, temperature=temps,
                                        top_k=top_k, top_p=top_p)

    off = draw(None, None)
    assert torch.equal(off, draw(torch.zeros(3, dtype=torch.int64),
                                 torch.zeros(3)))
    mixed = draw(torch.tensor([0, 5, 0]), torch.tensor([0.0, 0.0, 0.9]))
    assert mixed[0] == off[0]
    for i, (k, p) in enumerate([(5, 0.0), (0, 0.9)], start=1):
        g = torch.Generator().manual_seed(i + 1)
        assert mixed[i] == tsampling.sample(
            g, logits[i:i + 1], temperature=float(temps[i]), top_k=k,
            top_p=p)[0]
