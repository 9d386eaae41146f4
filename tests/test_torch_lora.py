"""The port's LoRA adapters: the adapters seam, LoRA training, the adapter
bank and multi-tenant serving, against the JAX package.

- fold_factors and merge_lora bit for bit against JAX in fp32 (tiny Llama
  and tiny Falcon, whose wkv holds one kv head); the `.npz` export read
  both ways.
- The `adapters=` forward and loss_fn within 1e-5 of JAX's, with a bank of
  three rows and mixed row indices; three make_lora_step steps from the
  same numpy factors and batches within 1e-5 (factors and losses).
- The bank against the JAX AdapterBank on one sequence of registrations,
  loads, evictions, host demotions and a corrupted host copy: the same
  rows, counters and locality signals.
- The engine with adapters against the JAX ServingEngine (block-native,
  Pallas interpret mode) with every request queued before the loop starts:
  the block pool, an int8 pool, chunked prefill, preemption and the w 5
  speculative verify; greedy tokens equal, logprobs within 1e-4, the same
  bank counters, and each row equal to its merged-weights serial oracle.
- Base rows under a bank give the adapterless engine's tokens and logprobs
  bit for bit; admission 400s, ServingConfig checks and the server's
  adapter statuses refuse what JAX refuses; finetune --lora_rank exports
  an adapter JAX reads; bench_lora's smoke holds every row.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from megatron_tpu import config as jconfig
from megatron_tpu.inference.generation import Generator as JGenerator
from megatron_tpu.models import language_model as jlm
from megatron_tpu.models.attention import LoraAdapter as JLoraAdapter
from megatron_tpu.serving import SamplingOptions as JSamplingOptions
from megatron_tpu.serving import ServingEngine as JServingEngine
from megatron_tpu.serving import ServingMetrics as JServingMetrics
from megatron_tpu.serving import adapters as jad
from megatron_tpu.training import lora as jlora
from megatron_tpu.training.checkpointing import _flatten
from megatron_tpu_torch import config as tconfig
from megatron_tpu_torch.config import ServingConfig
from megatron_tpu_torch.convert.from_jax import params_from_numpy
from megatron_tpu_torch.inference.generation import (Generator,
                                                     SamplingParams)
from megatron_tpu_torch.models import language_model as lm
from megatron_tpu_torch.models.attention import LoraAdapter
from megatron_tpu_torch.models.language_model import LanguageModel
from megatron_tpu_torch.resilience.faults import FaultInjector
from megatron_tpu_torch.serving import (AdmissionError, SamplingOptions,
                                        ServingEngine, ServingMetrics)
from megatron_tpu_torch.serving import adapters as tad
from megatron_tpu_torch.training import lora as tlora

torch.set_num_threads(2)
TOL = 1e-4
RANK, ALPHA = 4, 8.0
PRESETS = {"llama": "llama2_config", "falcon": "falcon_config"}
GREEDY = SamplingOptions(temperature=0.0)
JGREEDY = JSamplingOptions(temperature=0.0)
PROMPTS = [[5, 17, 3, 42, 8, 9], [7, 8, 9], list(range(20, 41)),
           [11, 12, 13, 14]]
NEW = 10


def _models(name, **extra):
    fn = PRESETS[name]
    kw = dict(attention_impl="flash", compute_dtype="float32", **extra)
    jcfg = getattr(jconfig, fn)("tiny", **kw)
    tcfg = getattr(tconfig, fn)("tiny", **kw)
    params = jlm.model_init(jax.random.PRNGKey(0), jcfg)
    model = LanguageModel.from_state_dict(
        tcfg, params_from_numpy(_flatten(params), tcfg, device="cpu"))
    return jcfg, params, tcfg, model


@pytest.fixture(scope="module", params=sorted(PRESETS))
def models(request):
    return _models(request.param)


@pytest.fixture(scope="module")
def llama():
    return _models("llama")


def _factors(jcfg, seed, rank=RANK):
    return jad.random_adapter_factors(jcfg, rank, seed)


def test_fold_and_merge_match_jax(models):
    jcfg, params, tcfg, model = models
    raw = _factors(jcfg, 3, rank=2)
    for bank_rank in (2, 4):  # the second zero-pads
        got = tad.fold_factors(raw, 2, ALPHA, tcfg, bank_rank)
        want = jad.fold_factors(raw, 2, ALPHA, jcfg, bank_rank)
        for n in tad.FACTOR_NAMES:
            np.testing.assert_array_equal(got[n], want[n])
    f = _factors(jcfg, 5)
    got = tlora.merge_lora(model, f, tcfg, RANK, ALPHA)
    want = jlora.merge_lora(params, f, jcfg, RANK, ALPHA)
    for w in ("wq", "wkv", "wo"):
        np.testing.assert_array_equal(
            got["transformer"]["attention"][w].numpy(),
            np.asarray(want["transformer"]["attention"][w]))
    # the caller's weights are untouched
    np.testing.assert_array_equal(
        model.transformer["attention"]["wq"].detach().numpy(),
        np.asarray(params["transformer"]["attention"]["wq"]))
    assert tad.adapter_factor_shapes(tcfg, RANK) == \
        jad.adapter_factor_shapes(jcfg, RANK)
    assert tad.adapter_bank_nbytes(tcfg, 3, RANK) == \
        jad.adapter_bank_nbytes(jcfg, 3, RANK)


def test_export_reads_both_ways(llama, tmp_path):
    jcfg, _, tcfg, _ = llama
    f = _factors(jcfg, 7)
    tlora.export_adapter(str(tmp_path / "t.npz"), f, rank=RANK, alpha=ALPHA,
                         meta={"who": "port"})
    jlora.export_adapter(str(tmp_path / "j.npz"), f, rank=RANK, alpha=ALPHA,
                         meta={"who": "jax"})
    for reader in (tad.load_adapter_npz, jad.load_adapter_npz):
        for src in ("t", "j"):
            factors, rank, alpha, meta = reader(str(tmp_path / f"{src}.npz"))
            assert (rank, alpha) == (RANK, ALPHA)
            assert meta["who"] == ("port" if src == "t" else "jax")
            for n in tad.FACTOR_NAMES:
                np.testing.assert_array_equal(factors[n], f[n])
    # a torch tensor exports the same file
    tlora.export_adapter(str(tmp_path / "tt.npz"),
                         {n: torch.from_numpy(v) for n, v in f.items()},
                         rank=RANK, alpha=ALPHA)
    got, *_ = jad.load_adapter_npz(str(tmp_path / "tt.npz"))
    np.testing.assert_array_equal(got["bo"], f["bo"])


def _bank(jcfg, seeds):
    """A 1 + len(seeds)-row stacked bank (row 0 zero), folded as the
    serving bank folds: numpy arrays [L, n, ...]."""
    rows = [jad.fold_factors(_factors(jcfg, s), RANK, ALPHA, jcfg, RANK)
            for s in seeds]
    return {n: np.stack([np.zeros_like(rows[0][n])] + [r[n] for r in rows],
                        axis=1) for n in tad.FACTOR_NAMES}


def test_adapter_forward_and_loss_match_jax(models):
    jcfg, params, tcfg, model = models
    bank = _bank(jcfg, (11, 12))
    idx = np.array([2, 0, 1])
    rs = np.random.RandomState(0)
    toks = rs.randint(1, jcfg.vocab_size, (3, 13))
    want, _ = jlm.model_forward(
        params, jnp.asarray(toks[:, :-1]), jcfg,
        adapters=(JLoraAdapter(**{n: jnp.asarray(v)
                                  for n, v in bank.items()}),
                  jnp.asarray(idx)))
    got, _ = lm.model_forward(
        model, torch.from_numpy(toks[:, :-1]), tcfg,
        adapters=(LoraAdapter(**{n: torch.from_numpy(v)
                                 for n, v in bank.items()}),
                  torch.from_numpy(idx)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    # the adapters are live: row 0 (index 2) differs from the base model
    base, _ = lm.model_forward(model, torch.from_numpy(toks[:, :-1]), tcfg)
    assert not torch.allclose(base[0], got[0])
    torch.testing.assert_close(base[1], got[1], rtol=0, atol=0)
    f = _factors(jcfg, 21)
    mask = (rs.rand(3, 13) > 0.2).astype(np.float32)
    jl = jlm.loss_fn(params, jnp.asarray(toks), jcfg,
                     loss_mask=jnp.asarray(mask),
                     adapters=jlora.lora_adapters(
                         {n: jnp.asarray(v) for n, v in f.items()},
                         RANK, ALPHA, 3))
    tl = lm.loss_fn(model, torch.from_numpy(toks), tcfg,
                    loss_mask=torch.from_numpy(mask),
                    adapters=tlora.lora_adapters(
                        {n: torch.from_numpy(v) for n, v in f.items()},
                        RANK, ALPHA, 3))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-5)


def test_lora_steps_match_jax(models):
    jcfg, params, tcfg, model = models
    f0 = {n: np.asarray(v) for n, v in jlora.lora_init(
        jax.random.PRNGKey(3), jcfg, RANK).items()}
    # the reference's default lr: Adam's first steps move each factor by
    # about lr, so a gradient near zero turns float summation order into
    # an error proportional to lr
    jstep, jinit = jlora.make_lora_step(params, jcfg, RANK, ALPHA)
    tstep, tinit = tlora.make_lora_step(model, tcfg, RANK, ALPHA)
    jf = {n: jnp.asarray(v) for n, v in f0.items()}
    tf = {n: torch.from_numpy(v.copy()) for n, v in f0.items()}
    jopt, topt = jinit(jf), tinit(tf)
    rs = np.random.RandomState(1)
    for _ in range(3):
        toks = rs.randint(1, jcfg.vocab_size, (2, 17))
        mask = (rs.rand(2, 17) > 0.1).astype(np.float32)
        jf, jopt, jloss = jstep(jf, jopt, jnp.asarray(toks),
                                jnp.asarray(mask))
        tf, topt, tloss = tstep(tf, topt, torch.from_numpy(toks),
                                torch.from_numpy(mask))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5,
                                   atol=1e-5)
        for n in tad.FACTOR_NAMES:
            np.testing.assert_allclose(tf[n].numpy(), np.asarray(jf[n]),
                                       rtol=1e-5, atol=1e-5, err_msg=n)
    assert float(np.abs(tf["bq"].numpy()).max()) > 0  # B switched on
    # the base stayed frozen and untouched
    assert not any(p.requires_grad for p in model.parameters())


def test_lora_init_shapes_and_zero_b(llama):
    _, _, tcfg, _ = llama
    f = tlora.lora_init(torch.Generator().manual_seed(0), tcfg, RANK)
    for n, shape in tad.adapter_factor_shapes(tcfg, RANK).items():
        assert tuple(f[n].shape) == shape
        assert (f[n].abs().sum() == 0) == n.startswith("b")
    again = tlora.lora_init(torch.Generator().manual_seed(0), tcfg, RANK)
    torch.testing.assert_close(f["aq"], again["aq"], rtol=0, atol=0)


def test_bank_matches_jax_bank(llama, tmp_path):
    """Registrations by path and by arrays, loads into a 2-row bank,
    evictions demoting path adapters to a host budget of two, a host hit,
    a corrupted host copy reloading from disk, a re-registration and the
    swap's generation bump: the same rows, counters and signals."""
    jcfg, _, tcfg, _ = llama
    tm, jm = ServingMetrics(), JServingMetrics()
    ours = tad.AdapterBank(tcfg, 2, RANK, host_bytes=1 << 20, metrics=tm)
    ref = jad.AdapterBank(jcfg, 2, RANK, host_bytes=1 << 20, metrics=jm)
    for i in range(3):
        tlora.export_adapter(str(tmp_path / f"p{i}.npz"),
                             _factors(jcfg, 40 + i, rank=2), rank=2,
                             alpha=ALPHA)
    arrays = _factors(jcfg, 50)
    for b in (ours, ref):
        for i in range(3):
            b.register(f"p{i}", path=str(tmp_path / f"p{i}.npz"))
        b.register("a", factors=arrays, rank=RANK, alpha=ALPHA)

    def both(fn):
        got, want = fn(ours), fn(ref)
        assert got == want
        return got

    def same_rows():
        for n in tad.FACTOR_NAMES:
            np.testing.assert_array_equal(
                getattr(ours.stacked, n).numpy(),
                np.asarray(getattr(ref.stacked, n)))

    inj = FaultInjector()
    for step, aid in enumerate(["p0", "p1", "p2", "p0", "a", "p1", "p0"]):
        if step == 5:
            inj.corrupt_adapter_host_entry(ours)
            inj.corrupt_adapter_host_entry(ref)
        idx = both(lambda b: b.acquire(aid))
        both(lambda b: b.release(idx))
        same_rows()
        both(lambda b: [b.peek(x) for x in ("p0", "p1", "p2", "a", "z")])
        both(lambda b: b.active_count())
    with pytest.raises(AdmissionError):
        ours.acquire("z")
    for b in (ours, ref):  # pin both rows: the bank is full
        b.acquire("p0"), b.acquire("p1")
    with pytest.raises(tad.AdapterBankFullError):
        ours.acquire("a")
    with pytest.raises(jad.AdapterBankFullError):
        ref.acquire("a")
    ours.reset_pins(), ref.reset_pins()
    ns = both(lambda b: b.namespace("p0"))
    both(lambda b: b.register("p0", factors=arrays, rank=RANK, alpha=1.0))
    assert both(lambda b: b.namespace("p0")) != ns
    assert both(lambda b: b.bump_generations()) == 4
    both(lambda b: [b.peek(x) for x in ("p0", "p1", "p2", "a")])
    tsnap, jsnap = tm.snapshot(), jm.snapshot()
    for key in ("adapter_loads", "adapter_evictions", "adapter_host_hits",
                "adapter_host_checksum_misses"):
        assert tsnap[key] == jsnap[key], key
    assert tsnap["adapter_host_checksum_misses"] == 1
    assert tsnap["adapter_host_hits"] >= 1


def _serve(submit, assignment, prompts=PROMPTS, new=NEW):
    reqs = [submit(p, new, a) for p, a in zip(prompts, assignment)]
    return [r.result(timeout=600) for r in reqs]


def _merged_oracle(model, tcfg, factors, prompts, assignment, new=NEW,
                   eos=-1, kv_dtype=torch.float32):
    out = []
    for p, aid in zip(prompts, assignment):
        params = (model if aid is None else tlora.merge_lora(
            model, factors[aid], tcfg, RANK, ALPHA))
        g = Generator(params, tcfg, eos_id=eos, pad_id=0,
                      kv_cache_dtype=kv_dtype, device="cpu")
        t, lens, _ = g.generate([p], new,
                                sampling=SamplingParams(temperature=0.0))
        out.append(t[0, :lens[0]].tolist())
    return out


ENGINE_CASES = {
    "block": ("falcon", dict(kv_block_size=16, block_native_attn=True)),
    "int8": ("llama", dict(kv_block_size=16, block_native_attn=True,
                           kv_dtype="int8")),
    "chunked": ("llama", dict(kv_block_size=16, block_native_attn=True,
                              prefill_chunk=16)),
    "spec": ("llama", dict(kv_block_size=16, block_native_attn=True,
                           speculative_k=4)),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_adapter_engine_matches_jax_engine(case):
    """Three adapters into a bank of two rows over three slots: the third
    adapter request waits for a pin to free (or evicts), every request
    queued before either loop starts so both engines admit alike."""
    name, extra = ENGINE_CASES[case]
    jcfg, params, tcfg, model = _models(name)
    factors = {f"t{i}": _factors(jcfg, 60 + i) for i in range(3)}
    assignment = ["t0", "t1", None, "t2"]
    kw = dict(num_slots=3, max_len=128, adapter_slots=2, adapter_rank=RANK,
              **extra)
    jeng = JServingEngine(JGenerator(params, jcfg, eos_id=-1, pad_id=0,
                                     kv_cache_dtype=jnp.float32),
                          jconfig.ServingConfig(**kw), start=False)
    try:
        for aid, f in factors.items():
            jeng.register_adapter(aid, factors=f, rank=RANK, alpha=ALPHA)
        jreqs = [jeng.submit(p, NEW, JGREEDY, adapter_id=a)
                 for p, a in zip(PROMPTS, assignment)]
        jeng._thread.start()
        want = [r.result(timeout=600) for r in jreqs]
        jsnap = jeng.metrics.snapshot()
    finally:
        jeng.close()
    gen = Generator(model, tcfg, eos_id=-1, pad_id=0,
                    kv_cache_dtype=torch.float32, device="cpu")
    eng = ServingEngine(gen, ServingConfig(**kw), device="cpu", start=False)
    try:
        for aid, f in factors.items():
            eng.register_adapter(aid, factors=f, rank=RANK, alpha=ALPHA)
        reqs = [eng.submit(p, NEW, GREEDY, adapter_id=a)
                for p, a in zip(PROMPTS, assignment)]
        eng._thread.start()
        got = [r.result(timeout=600) for r in reqs]
        snap = eng.metrics.snapshot()
        assert eng.health()["active_adapters"] == 2
    finally:
        eng.close()
    for (gt, glp), (wt, wlp) in zip(got, want):
        assert gt == wt
        np.testing.assert_allclose(glp, wlp, rtol=TOL, atol=TOL)
    for key in ("adapter_loads", "adapter_evictions", "adapter_host_hits",
                "spec_rounds", "prefill_chunks", "active_adapters"):
        assert snap[key] == jsnap[key], key
    assert snap["adapter_loads"] >= 3
    # the serial oracle on the same cache layout
    assert [t for t, _ in got] == _merged_oracle(
        model, tcfg, factors, PROMPTS, assignment,
        kv_dtype=torch.int8 if case == "int8" else torch.float32)


def test_preempted_adapter_request_resumes_under_its_adapter(llama):
    """A priority-1 request under adapter b preempts a running request
    under adapter a (one slot): both give JAX's tokens and their merged
    oracles', the victim re-acquiring its adapter at resume."""
    import time
    jcfg, params, tcfg, model = llama
    factors = {"a": _factors(jcfg, 70), "b": _factors(jcfg, 71)}
    kw = dict(num_slots=1, max_len=128, kv_block_size=16,
              block_native_attn=True, adapter_slots=2, adapter_rank=RANK,
              priority_levels=2, preemption=True)

    def run(eng, opts):
        for aid, f in factors.items():
            eng.register_adapter(aid, factors=f, rank=RANK, alpha=ALPHA)
        victim = eng.submit(PROMPTS[0], 24, opts, priority=0,
                            adapter_id="a")
        deadline = time.monotonic() + 300
        while len(victim.generated) < 2:
            assert time.monotonic() < deadline
            time.sleep(0.002)
        hi = eng.submit(PROMPTS[1], 4, opts, priority=1, adapter_id="b")
        out = [victim.result(timeout=600), hi.result(timeout=600)]
        assert eng.metrics.snapshot()["preemptions"] >= 1
        return out

    jeng = JServingEngine(JGenerator(params, jcfg, eos_id=-1, pad_id=0,
                                     kv_cache_dtype=jnp.float32),
                          jconfig.ServingConfig(**kw))
    try:
        want = run(jeng, JGREEDY)
    finally:
        jeng.close()
    gen = Generator(model, tcfg, eos_id=-1, pad_id=0,
                    kv_cache_dtype=torch.float32, device="cpu")
    with ServingEngine(gen, ServingConfig(**kw), device="cpu") as eng:
        got = run(eng, GREEDY)
    for (gt, glp), (wt, wlp) in zip(got, want):
        assert gt == wt
        np.testing.assert_allclose(glp, wlp, rtol=TOL, atol=TOL)
    assert got[0][0] == _merged_oracle(model, tcfg, factors, [PROMPTS[0]],
                                       ["a"], new=24)[0]


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_base_rows_under_a_bank_equal_the_adapterless_engine(llama, kv):
    """Row 0's zero delta adds exactly 0: base rows beside adapter rows
    give the tokens and logprobs of an engine with no bank, bit for bit;
    with adapter_slots=0 the engine has no bank at all."""
    jcfg, _, tcfg, model = llama
    gen = Generator(model, tcfg, eos_id=-1, pad_id=0,
                    kv_cache_dtype=torch.float32, device="cpu")
    kw = dict(num_slots=3, max_len=128, kv_block_size=16,
              block_native_attn=True, kv_dtype=kv)
    with ServingEngine(gen, ServingConfig(**kw), device="cpu") as eng:
        assert eng.adapters is None
        plain = _serve(lambda p, n, a: eng.submit(p, n, GREEDY),
                       [None] * 4)
    with ServingEngine(gen, ServingConfig(adapter_slots=2, adapter_rank=RANK,
                                          **kw), device="cpu") as eng:
        eng.register_adapter("t", factors=_factors(jcfg, 80), rank=RANK,
                             alpha=ALPHA)
        mixed = _serve(lambda p, n, a: eng.submit(p, n, GREEDY,
                                                  adapter_id=a),
                       [None, "t", None, "t"])
    for i in (0, 2):
        assert mixed[i][0] == plain[i][0]
        assert mixed[i][1] == plain[i][1]  # logprobs bit for bit
    assert mixed[1][0] != plain[1][0]


def test_admission_and_validation_refuse_what_jax_refuses(llama, tmp_path):
    jcfg, params, tcfg, model = llama
    gen = Generator(model, tcfg, eos_id=-1, pad_id=0, device="cpu")
    jgen = JGenerator(params, jcfg, eos_id=-1, pad_id=0,
                      kv_cache_dtype=jnp.float32)
    # an adapter on an adapterless engine, an unknown adapter
    for kw in (dict(), dict(adapter_slots=1, adapter_rank=RANK)):
        jeng = JServingEngine(jgen, jconfig.ServingConfig(max_len=64, **kw),
                              start=False)
        with ServingEngine(gen, ServingConfig(max_len=64, **kw),
                           device="cpu", start=False) as eng:
            with pytest.raises(jad.UnknownAdapterError):
                jeng.submit([1, 2], 2, JGREEDY, adapter_id="nope")
            with pytest.raises(tad.UnknownAdapterError):
                eng.submit([1, 2], 2, GREEDY, adapter_id="nope")
            assert eng.metrics.snapshot()["requests_rejected"] == 1
        jeng.close()
    # ServingConfig checks: JAX asserts, the port raises ValueError
    bad = [dict(adapter_slots=2, adapter_rank=0),
           dict(adapter_slots=2, serial_fallback=True),
           dict(adapter_host_bytes=1024),
           dict(adapter_slots=2, adapter_rank=8, adapter_max_bank_bytes=10),
           dict(watch_checkpoints="/x", serial_fallback=True),
           dict(swap_timeout_s=0.0), dict(watch_interval_s=-1.0)]
    for kw in bad:
        with pytest.raises(AssertionError):
            jconfig.ServingConfig(**kw).validate(jcfg)
        with pytest.raises(ValueError):
            ServingConfig(**kw).validate(tcfg)
    q_j = jconfig.llama2_config("tiny", quantized_gemm="int8")
    q_t = tconfig.llama2_config("tiny", quantized_gemm="int8")
    with pytest.raises(AssertionError):
        jconfig.ServingConfig(adapter_slots=1).validate(q_j)
    with pytest.raises(ValueError, match="quantized_gemm"):
        ServingConfig(adapter_slots=1).validate(q_t)
    fit = tad.adapter_bank_nbytes(tcfg, 2, 8)
    ServingConfig(adapter_slots=2, adapter_max_bank_bytes=fit).validate(tcfg)
    # a wrong-shape adapter fails at registration, not at admission
    wrong = _factors(jconfig.llama2_config("tiny", num_layers=1), 12)
    tlora.export_adapter(str(tmp_path / "w.npz"), wrong, rank=RANK,
                         alpha=ALPHA)
    bank = tad.AdapterBank(tcfg, 1, RANK)
    with pytest.raises(ValueError, match="shape"):
        bank.register("w", path=str(tmp_path / "w.npz"))
    with pytest.raises(ValueError, match="shape"):
        jad.AdapterBank(jcfg, 1, RANK).register("w",
                                                path=str(tmp_path / "w.npz"))
    with pytest.raises(ValueError, match="exceeds"):
        bank.register("big", factors=_factors(jcfg, 1, rank=8), rank=8)


class _Tok:
    eod = 0

    def tokenize(self, text):
        return [3 + (ord(c) % 50) for c in text]

    def detokenize(self, ids):
        return "".join(chr(97 + i % 26) for i in ids)


def test_server_adapter_statuses_match_jax(llama, tmp_path):
    """The /api payload field and PUT /admin register_adapter: the JAX
    MegatronServer's statuses beside the port's, and a registered adapter's
    stream equal to its merged oracle."""
    from megatron_tpu.inference.server import MegatronServer as JServer
    from megatron_tpu_torch.inference.server import MegatronServer
    jcfg, params, tcfg, model = llama
    f = _factors(jcfg, 90)
    path = str(tmp_path / "tenant.npz")
    tlora.export_adapter(path, f, rank=RANK, alpha=ALPHA)
    gen = Generator(model, tcfg, eos_id=-1, pad_id=0,
                    kv_cache_dtype=torch.float32, device="cpu")
    sc = dict(num_slots=2, max_len=64, adapter_slots=1, adapter_rank=RANK)
    server = MegatronServer(gen, _Tok(), serving=ServingConfig(**sc),
                            device="cpu")
    jserver = JServer(JGenerator(params, jcfg, eos_id=-1, pad_id=0,
                                 kv_cache_dtype=jnp.float32), _Tok(),
                      serving=jconfig.ServingConfig(**sc))
    base = {"prompts": ["hello"], "tokens_to_generate": 5,
            "temperature": 0.0}
    cases = [
        ("admin", {"op": "register_adapter", "adapter_id": "tenant",
                   "path": path}),
        ("admin", {"op": "register_adapter", "path": path}),
        ("admin", {"op": "nope"}),
        ("admin", {"op": "swap_weights"}),
        ("admin", "not a dict"),
        ("api", dict(base, adapter_id="unknown")),
        ("api", dict(base, adapter_id=["list"])),
        ("api", dict(base, adapter_id="tenant", serial=True)),
        ("api", dict(base, adapter_id="tenant", beam_width=2)),
        ("api", dict(base, adapter_id="tenant")),
    ]
    try:
        for kind, payload in cases:
            if kind == "admin":
                got = server.handle_admin(payload)[0]
                want = jserver.handle_admin(payload)[0]
            else:
                got = server.handle(payload)[0]
                want = jserver.handle(payload)[0]
            assert got == want, (payload, got, want)
        status, body = server.handle(dict(base, adapter_id="tenant"))
        ids = _Tok().tokenize("hello")
        assert body["segments"][0] == _merged_oracle(
            model, tcfg, {"tenant": f}, [ids], ["tenant"], new=5)[0]
        h = server.healthz()[1]
        assert h["active_adapters"] == 1
        snap = server.metrics_snapshot()
        assert snap["adapter_loads"] == 1 and snap["active_adapters"] == 1
    finally:
        server.close()
        jserver.close()


def test_finetune_lora_rank_exports_a_servable_adapter(tmp_path,
                                                       monkeypatch):
    """`python -m megatron_tpu_torch.finetune --lora_rank 3` on a tiny
    corpus: the exported adapter is read by the JAX bank, its B factors
    trained away from zero, and it serves on the port's engine."""
    from megatron_tpu_torch import finetune
    from megatron_tpu_torch.tools import preprocess_data as t_pre
    from megatron_tpu_torch.tools import synthetic_corpus as sc
    vocab, merges = sc.write_gpt2_vocab(str(tmp_path), 300)
    jsonl = sc.write_jsonl(str(tmp_path / "c.jsonl"), 40, 2, min_words=5,
                           max_words=30)
    t_pre.main(["--input", jsonl, "--output_prefix", str(tmp_path / "c"),
                "--tokenizer_type", "GPT2BPETokenizer", "--vocab_file",
                vocab, "--merge_file", merges, "--append_eod"])
    out = str(tmp_path / "adapter.npz")
    argv = ["--model", "llama2-tiny", "--num_layers", "2", "--hidden_size",
            "64", "--num_attention_heads", "4", "--num_attention_heads_kv",
            "2", "--seq_length", "32", "--use_flash_attn", "--data_path",
            str(tmp_path / "c_document"), "--split", "100,0,0",
            "--tokenizer_type", "GPT2BPETokenizer", "--vocab_file", vocab,
            "--merge_file", merges, "--micro_batch_size", "2",
            "--global_batch_size", "2", "--train_iters", "4", "--lr",
            "1e-2", "--log_interval", "2", "--lora_rank", "3",
            "--lora_alpha", "6", "--lora_export", out]
    assert finetune.main(argv, device="cpu") == 0
    factors, rank, alpha, meta = jad.load_adapter_npz(out)
    assert (rank, alpha, meta["num_layers"]) == (3, 6.0, 2)
    assert np.abs(factors["bq"]).max() > 0
    assert len(tlora.last_run["step_ms"]) == 4
    from megatron_tpu_torch.arguments import parse_cli
    cfg, _ = parse_cli(argv)
    bank = tad.AdapterBank(cfg.model, 1, 4)
    bank.register("trained", path=out)  # rank 3 pads into a rank-4 bank


def test_bench_lora_smoke_holds_every_row():
    from megatron_tpu_torch.tools import bench_lora
    assert bench_lora.main(["--smoke"], device="cpu") == 0
