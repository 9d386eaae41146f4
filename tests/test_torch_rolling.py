"""Rolling sliding-window KV caches and the bracketed block pool in the port
(inference/generation.py, models/attention.py, serving/kv_pool.py,
serving/engine.py), against the JAX package.

- The rolling decision: `kv_region_cap` and `init_kv_caches` equal JAX's
  over flash/dot impls, windows and prefill lengths (a dot prefill longer
  than W keeps the full-length region), as do the pool's cap, `rolling`,
  block size and `slot_nbytes`.
- Serial: greedy tokens (and logprobs within 1e-4, fp32 compute) equal
  JAX's Generator on bf16 and int8 rings, with prompts longer than W and
  generation across the wrap, on the flash impl (kernel 1's plain version
  with the window at s > W) and on the dot impl (prefill <= W).
- The engine: the whole-region rolling pool, the bracketed pool
  (kv_block_size without block_native_attn) on a rolling and on a flat
  model, and the int8 rolling pool each give JAX's engine's greedy tokens
  and the port's serial route's seeded stochastic ones; the bracket moves
  2 x view bytes a decode step (kv_gather_bytes_per_step) and the other
  paths none.
- `resolve_view`, `scatter_view` and `slice_blocks` equal JAX's on the
  same arena and map.
- The reference's TestEngineKvVariants and plain TestRollingBlocks cases,
  ported.
- A row at the capacity clamp writes nothing past its region; a
  multi-token step at offset > 0 on a ring, and a multi-token slot-grid
  append on a ring, raise; validate's rolling exclusions match JAX's.
Tolerances: greedy tokens exact; logprobs 1e-4 (fp32 compute).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu import config as jconfig
from megatron_tpu.inference import generation as jgeneration
from megatron_tpu.inference.generation import Generator as JGenerator
from megatron_tpu.inference.generation import SamplingParams as JSP
from megatron_tpu.models import language_model as jlm
from megatron_tpu.models.attention import KVCache as JKVCache
from megatron_tpu.serving import SamplingOptions as JSamplingOptions
from megatron_tpu.serving import ServingEngine as JServingEngine
from megatron_tpu.serving import kv_pool as jkv_pool
from megatron_tpu.training.checkpointing import _flatten
from megatron_tpu_torch import config as tconfig
from megatron_tpu_torch.config import ServingConfig
from megatron_tpu_torch.convert.from_jax import params_from_numpy
from megatron_tpu_torch.inference import generation as tgeneration
from megatron_tpu_torch.inference.generation import Generator, SamplingParams
from megatron_tpu_torch.models.attention import KVCache, attention_apply
from megatron_tpu_torch.models.language_model import LanguageModel
from megatron_tpu_torch.serving import SamplingOptions, ServingEngine
from megatron_tpu_torch.serving import kv_pool as tkv_pool

torch.set_num_threads(2)
TOL = 1e-4
W = 16
ROLL = dict(sliding_window=W, seq_length=128, max_position_embeddings=128,
            compute_dtype="float32")
NEW = 24  # crosses the 16-position ring for every prompt below
PROMPTS = [[5, 17, 3, 9, 2, 8], list(range(30, 50)),
           list(range(100, 140)), [7, 8, 9, 10, 11, 12, 13, 14, 15, 16]]


def _models(impl="flash", **kw):
    jcfg = jconfig.llama2_config("tiny", attention_impl=impl, **ROLL, **kw)
    tcfg = tconfig.llama2_config("tiny", attention_impl=impl, **ROLL, **kw)
    params = jlm.model_init(jax.random.PRNGKey(0), jcfg)
    model = LanguageModel.from_state_dict(
        tcfg, params_from_numpy(_flatten(params), tcfg, device="cpu"))
    return jcfg, params, tcfg, model


@pytest.fixture(scope="module")
def flash():
    return _models("flash")


@pytest.mark.parametrize("impl", ["flash", "dot"])
@pytest.mark.parametrize("window", [None, 8, 64, 200])
@pytest.mark.parametrize("max_len,prefill_len",
                         [(64, None), (64, 6), (64, 40), (128, 100)])
def test_region_cap_matches_jax(impl, window, max_len, prefill_len):
    jcfg = jconfig.llama2_config("tiny", attention_impl=impl,
                                 sliding_window=window)
    tcfg = tconfig.llama2_config("tiny", attention_impl=impl,
                                 sliding_window=window)
    want = jgeneration.kv_region_cap(jcfg, max_len, prefill_len)
    assert tgeneration.kv_region_cap(tcfg, max_len, prefill_len) == want
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.int8, jnp.int8)):
        jc = jgeneration.init_kv_caches(jcfg, 2, max_len, dtype=jdt,
                                        prefill_len=prefill_len)
        tc = tgeneration.init_kv_caches(tcfg, 2, max_len, dtype=dt,
                                        prefill_len=prefill_len)
        assert tuple(tc.k.shape) == jc.k.shape
        assert (tc.k_scale is None) == (jc.k_scale is None)
    pool = tkv_pool.SlotKVPool(tcfg, 2, max_len, block_size=8,
                               device="cpu")
    jpool = jkv_pool.SlotKVPool(jcfg, 2, max_len, block_size=8)
    assert (pool.cap, pool.rolling, pool.block_size) == (
        jpool.cap, jpool.rolling, jpool.block_size)
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.int8, jnp.int8)):
        assert tkv_pool.slot_nbytes(tcfg, max_len, dt, 8) == \
            jkv_pool.slot_nbytes(jcfg, max_len, jdt, 8)


def test_rolling_pool_layout_and_prefill_caches():
    tcfg = tconfig.llama2_config("tiny", sliding_window=16,
                                 attention_impl="flash", seq_length=64,
                                 max_position_embeddings=64)
    pool = tkv_pool.SlotKVPool(tcfg, 2, 64, device="cpu")
    assert pool.cap == 16 and pool.rolling
    # the prefill caches share the ring layout
    assert pool.make_prefill_caches(1, 40).k.shape[2] == 16
    # one block a slot stays a block pool on a ring
    pool = tkv_pool.SlotKVPool(tcfg, 2, 64, block_size=16, device="cpu")
    assert pool.blocks_enabled and pool.blocks_per_slot == 1
    assert pool.view_nbytes() == 2 * 16 * pool.bytes_per_token()


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("impl", ["flash", "dot"])
def test_serial_rolling_matches_jax(kv, impl):
    jcfg, params, tcfg, model = _models(impl)
    jdt, tdt = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
                "int8": (jnp.int8, torch.int8)}[kv]
    jgen = JGenerator(params, jcfg, eos_id=0, pad_id=0, kv_cache_dtype=jdt)
    tgen = Generator(model, tcfg, eos_id=0, pad_id=0, device="cpu",
                     kv_cache_dtype=tdt)
    # the dot impl rolls only when the prefill fits the window
    prompts = PROMPTS if impl == "flash" else [p[:W] for p in PROMPTS]
    for batch in ([p] for p in prompts):
        want_t, want_l, want_lp = jgen.generate(
            batch, NEW, sampling=JSP(temperature=0.0))
        got_t, got_l, got_lp = tgen.generate(
            batch, NEW, sampling=SamplingParams(temperature=0.0))
        n = int(want_l[0])
        assert got_t[0, :n].tolist() == np.asarray(want_t)[0, :n].tolist()
        if kv == "bfloat16":
            np.testing.assert_allclose(got_lp[0, len(batch[0]):n],
                                       np.asarray(want_lp)[0,
                                                           len(batch[0]):n],
                                       rtol=TOL, atol=TOL)
    # rows of different lengths in one batch: the shorter ones step
    # through the rest of their prompts on the ring
    want_t, want_l, _ = jgen.generate(prompts[:2], NEW,
                                      sampling=JSP(temperature=0.0))
    got_t, got_l, _ = tgen.generate(prompts[:2], NEW,
                                    sampling=SamplingParams(temperature=0.0))
    assert got_l.tolist() == np.asarray(want_l).tolist()
    for i, n in enumerate(got_l):
        assert got_t[i, :n].tolist() == np.asarray(want_t)[i, :n].tolist()


ARMS = {"region": dict(), "bracketed": dict(kv_block_size=8),
        "int8": dict(kv_dtype="int8"),
        "int8_bracketed": dict(kv_dtype="int8", kv_block_size=16)}


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_engine_arms_match_jax_engine(flash, arm):
    jcfg, params, tcfg, model = flash
    sv = dict(num_slots=2, max_queue=16, max_len=64, **ARMS[arm])
    jeng = JServingEngine(JGenerator(params, jcfg, eos_id=0, pad_id=0),
                          jconfig.ServingConfig(**sv))
    try:
        reqs = [jeng.submit(p, NEW, JSamplingOptions(temperature=0.0))
                for p in PROMPTS]
        want = [r.result(timeout=600) for r in reqs]
    finally:
        jeng.close()
    gen = Generator(model, tcfg, eos_id=0, pad_id=0, device="cpu")
    with ServingEngine(gen, ServingConfig(**sv), device="cpu") as eng:
        assert eng.pool.rolling and eng.pool.cap == W
        reqs = [eng.submit(p, NEW, SamplingOptions(temperature=0.0))
                for p in PROMPTS]
        got = [r.result(timeout=600) for r in reqs]
        snap = eng.metrics.snapshot()
        view = eng.pool.view_nbytes()
    for (gt, glp), (wt, wlp) in zip(got, want):
        assert gt == wt
        if "int8" not in arm:
            np.testing.assert_allclose(glp, wlp, rtol=TOL, atol=TOL)
    blocks = "kv_block_size" in ARMS[arm]
    assert snap["kv_attn_path"] == (1.0 if blocks else 0.0)
    # the last window held decode steps only: one gather + one scatter each
    assert snap["kv_gather_bytes_per_step"] == (2 * view if blocks else 0)


@pytest.fixture(scope="module")
def fp32_gen(flash):
    _, _, tcfg, model = flash
    return Generator(model, tcfg, eos_id=0, pad_id=0, device="cpu",
                     kv_cache_dtype=torch.float32)


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_engine_arms_equal_serial_seeded(fp32_gen, arm):
    kw = dict(ARMS[arm])
    gen = fp32_gen
    if kw.pop("kv_dtype", None) == "int8":
        gen = Generator(gen.params, gen.cfg, eos_id=0, pad_id=0,
                        device="cpu", kv_cache_dtype=torch.int8)
    sp = SamplingOptions(temperature=0.8, top_k=20, top_p=0.9)
    with ServingEngine(gen, ServingConfig(num_slots=2, max_len=64, **kw),
                       device="cpu") as eng:
        reqs = [eng.submit(p, NEW, sp, seed=10 + i)
                for i, p in enumerate(PROMPTS)]
        got = [r.result(timeout=600)[0] for r in reqs]
    for i, (p, g) in enumerate(zip(PROMPTS, got)):
        toks, lens, _ = gen.generate(
            [p], NEW, sampling=SamplingParams(0.8, 20, 0.9), seed=10 + i)
        assert g == toks[0, :lens[0]].tolist(), (arm, i)


def test_bracketed_flat_pool_equals_block_native_and_region():
    """On a model without a window the bracket gives the block-native
    engine's and the whole-region engine's greedy tokens."""
    tcfg = tconfig.llama2_config("tiny", attention_impl="flash",
                                 compute_dtype="float32")
    model = LanguageModel(tcfg, device="cpu", seed=3)
    gen = Generator(model, tcfg, eos_id=0, pad_id=0, device="cpu",
                    kv_cache_dtype=torch.float32)
    outs = []
    for kw in (dict(), dict(kv_block_size=16),
               dict(kv_block_size=16, block_native_attn=True)):
        with ServingEngine(gen, ServingConfig(num_slots=3, max_len=128,
                                              **kw), device="cpu") as eng:
            reqs = [eng.submit(p, 10, SamplingOptions(temperature=0.0))
                    for p in PROMPTS]
            outs.append([r.result(timeout=300)[0] for r in reqs])
            assert eng.metrics.snapshot()["kv_attn_path"] == (
                2 if kw.get("block_native_attn") else 1 if kw else 0)
    assert outs[0] == outs[1] == outs[2]


@pytest.mark.parametrize("int8", [False, True])
def test_view_functions_match_jax(int8):
    rs = np.random.RandomState(0)
    L, S, nb, B, nkv, hd = 2, 3, 4, 8, 2, 4
    total = S * nb + 1
    dt = np.int8 if int8 else np.float32
    k = rs.randint(-100, 100, (L, total, B, nkv, hd)).astype(dt)
    v = rs.randint(-100, 100, (L, total, B, nkv, hd)).astype(dt)
    ks = rs.rand(L, total, B, nkv, 1).astype(np.float32) if int8 else None
    vs = rs.rand(L, total, B, nkv, 1).astype(np.float32) if int8 else None
    bmap = rs.permutation(total - 1)[:S * nb].reshape(S, nb).astype(np.int32)
    bmap[2] = total - 1  # an idle row: every entry on TRASH
    offs = np.array([5, 20, 0], np.int32)

    def jbkv():
        sc = (None, None) if not int8 else (jnp.asarray(ks), jnp.asarray(vs))
        return jkv_pool.BlockKV(
            arena=JKVCache(jnp.asarray(k), jnp.asarray(v),
                           jnp.broadcast_to(jnp.asarray(offs)[None], (L, S)),
                           *sc), map=jnp.asarray(bmap))

    def tbkv():
        sc = ((None, None) if not int8 else
              (torch.from_numpy(ks.copy()), torch.from_numpy(vs.copy())))
        return tkv_pool.BlockKV(
            arena=KVCache(torch.from_numpy(k.copy()),
                          torch.from_numpy(v.copy()),
                          torch.from_numpy(offs.copy()), *sc),
            map=torch.from_numpy(bmap.copy()))

    jv, tv = jkv_pool.resolve_view(jbkv()), tkv_pool.resolve_view(tbkv())
    for name in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(jv, name), getattr(tv, name)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # an updated view scatters back to the same arena (live rows' blocks;
    # TRASH takes one of the idle row's copies in either package)
    upd = {n: (None if getattr(tv, n) is None else getattr(tv, n) + 1)
           for n in ("k", "v", "k_scale", "v_scale")}
    jout = jkv_pool.scatter_view(jbkv(), JKVCache(
        *(None if upd[n] is None else jnp.asarray(upd[n].numpy())
          for n in ("k", "v")), jnp.broadcast_to(jnp.asarray(offs)[None],
                                                 (L, S)),
        *(None if upd[n] is None else jnp.asarray(upd[n].numpy())
          for n in ("k_scale", "v_scale"))))
    tout = tkv_pool.scatter_view(tbkv(), KVCache(
        upd["k"], upd["v"], torch.from_numpy(offs.copy()), upd["k_scale"],
        upd["v_scale"]))
    live = bmap[:2].reshape(-1)
    for name in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(jout.arena, name), getattr(tout.arena, name)
        if a is not None:
            np.testing.assert_array_equal(b.numpy()[:, live],
                                          np.asarray(a)[:, live])
            np.testing.assert_array_equal(b.numpy()[:, :-1][:, ~np.isin(
                np.arange(total - 1), live)], np.asarray(a)[:, :-1][
                :, ~np.isin(np.arange(total - 1), live)])
    blocks = bmap[1]
    js = jkv_pool.slice_blocks(jbkv(), jnp.asarray(blocks), 7)
    ts = tkv_pool.slice_blocks(tbkv(), blocks.tolist(), 7)
    assert ts.offset == 7
    np.testing.assert_array_equal(ts.k.numpy(), np.asarray(js.k))
    if int8:
        np.testing.assert_array_equal(ts.v_scale.numpy(),
                                      np.asarray(js.v_scale))


def test_int8_pool_matches_serial_int8():
    """TestEngineKvVariants: an int8 pool stays token-exact against the
    serial int8 route."""
    tcfg = tconfig.llama2_config("tiny", attention_impl="flash",
                                 compute_dtype="float32")
    gen = Generator(LanguageModel(tcfg, device="cpu", seed=0), tcfg,
                    eos_id=0, pad_id=0, device="cpu",
                    kv_cache_dtype=torch.int8)
    with ServingEngine(gen, ServingConfig(num_slots=2, max_queue=16,
                                          max_len=64), device="cpu") as eng:
        reqs = [eng.submit(p, 6, SamplingOptions(temperature=0.0), seed=0)
                for p in PROMPTS]
        for p, r in zip(PROMPTS, reqs):
            toks, _ = r.result(timeout=300)
            want, lens, _ = gen.generate(
                [p], 6, sampling=SamplingParams(temperature=0.0))
            assert toks == want[0, :lens[0]].tolist()


def test_rolling_pool_matches_serial_rolling():
    """TestEngineKvVariants: a rolling pool (W 16) stays token-exact
    against the serial rolling route, 24 new tokens crossing the ring."""
    tcfg = tconfig.llama2_config("tiny", sliding_window=16,
                                 attention_impl="flash", seq_length=128,
                                 max_position_embeddings=128, vocab_size=96)
    gen = Generator(LanguageModel(tcfg, device="cpu", seed=0), tcfg,
                    eos_id=0, pad_id=0, device="cpu")
    rs = np.random.RandomState(0)
    prompts = [rs.randint(1, 96, n).tolist() for n in (6, 10, 20)]
    with ServingEngine(gen, ServingConfig(num_slots=2, max_queue=8,
                                          max_len=64), device="cpu") as eng:
        reqs = [eng.submit(p, 24, SamplingOptions(temperature=0.0), seed=0)
                for p in prompts]
        for p, r in zip(prompts, reqs):
            toks, _ = r.result(timeout=300)
            want, lens, _ = gen.generate(
                [p], 24, sampling=SamplingParams(temperature=0.0))
            assert toks == want[0, :lens[0]].tolist(), p


def test_plain_rolling_blocks_bit_identical():
    """TestRollingBlocks: a rolling pool with 16-token blocks (the
    bracket) gives the whole-region rolling pool's seeded streams."""
    tcfg = tconfig.llama2_config("tiny", sliding_window=32,
                                 attention_impl="flash", seq_length=96,
                                 max_position_embeddings=96)
    gen = Generator(LanguageModel(tcfg, device="cpu", seed=0), tcfg,
                    eos_id=0, pad_id=0, device="cpu")
    wave = [([5 + i, 6 + i, 7 + i], 8,
             SamplingOptions(temperature=0.7, top_k=5), i) for i in range(4)]
    outs = []
    for kw in (dict(), dict(kv_block_size=16)):
        with ServingEngine(gen, ServingConfig(num_slots=2, max_len=96, **kw),
                           device="cpu") as eng:
            reqs = [eng.submit(p, n, s, seed=seed) for p, n, s, seed in wave]
            outs.append([r.result(timeout=300)[0] for r in reqs])
    assert outs[0] == outs[1]


def _attn_inputs(cfg, b, s, seed=0):
    g = torch.Generator().manual_seed(seed)
    h, hd = cfg.hidden_size, cfg.kv_channels
    nq, nkv = cfg.num_attention_heads, cfg.num_kv_heads
    params = {"wq": torch.randn(h, nq * hd, generator=g) * 0.05,
              "wkv": torch.randn(h, 2 * nkv * hd, generator=g) * 0.05,
              "wo": torch.randn(nq * hd, h, generator=g) * 0.05}
    return params, torch.randn(b, s, h, generator=g)


def test_clamped_row_writes_nothing_past_its_region():
    """A slot-grid row at the capacity clamp appending 2 tokens writes its
    first at cap - 1 and drops the second (torch has no drop mode: the
    write is masked); the other rows and positions are untouched."""
    cfg = tconfig.llama2_config("tiny", compute_dtype="float32",
                                use_rotary_emb=False, attention_impl="dot")
    cap = 8
    cache = tgeneration.init_kv_caches(cfg, 2, cap, dtype=torch.float32,
                                       per_slot_offsets=True).layer(0)
    cache.k.fill_(7.0)
    cache.v.fill_(7.0)
    before = cache.k.clone()
    cache.offset = torch.tensor([cap - 1, 2], dtype=torch.int32)
    params, x = _attn_inputs(cfg, 2, 2)
    out, new = attention_apply(params, x, cfg, kv_cache=cache)
    assert torch.isfinite(out).all()
    changed = (cache.k != before).any(-1).any(-1)  # [b, cap]
    assert changed[0].nonzero().flatten().tolist() == [cap - 1]
    assert changed[1].nonzero().flatten().tolist() == [2, 3]
    assert new.offset.tolist() == [cap + 1, 4]


def test_rolling_writes_land_on_the_ring():
    """A ring of W slots after an s > W offset-0 prefill holds the last W
    positions at p % W; decode steps overwrite the oldest slot; a per-row
    ring write lands at offset % W."""
    cfg = tconfig.llama2_config("tiny", compute_dtype="float32",
                                sliding_window=4, attention_impl="flash")
    cache = tgeneration.init_kv_caches(cfg, 1, 64, dtype=torch.float32)
    layer = cache.layer(0)
    assert layer.k.shape[1] == 4
    params, x = _attn_inputs(cfg, 1, 10)
    pos = torch.arange(10)[None]
    rope = tconfig  # unused: the tiny llama needs tables
    from megatron_tpu_torch.models import language_model as lm
    cos, sin = lm.make_rope(cfg, max_len=64, device="cpu")
    out, new = attention_apply(params, x, cfg, rope_cos=cos, rope_sin=sin,
                               position_ids=pos, kv_cache=layer)
    # the same tokens through the uncached windowed path
    full, _ = attention_apply(params, x, cfg, rope_cos=cos, rope_sin=sin,
                              position_ids=pos)
    torch.testing.assert_close(out, full, rtol=1e-5, atol=1e-5)
    kv = (x @ params["wkv"]).reshape(1, 10, 2, cfg.num_kv_heads,
                                     cfg.kv_channels)
    from megatron_tpu_torch.models.rope import apply_rotary
    k = apply_rotary(kv[:, :, 0], cos, sin, pos)
    for p in range(6, 10):
        torch.testing.assert_close(layer.k[0, p % 4], k[0, p])
    assert new.offset == 10
    # a multi-token step at offset > 0 on the ring raises
    with pytest.raises(ValueError, match="rolling"):
        attention_apply(params, x[:, :2], cfg, rope_cos=cos, rope_sin=sin,
                        kv_cache=new)
    # a slot-grid ring: one write per row at offset % W, never past it
    grid = tgeneration.init_kv_caches(cfg, 2, 64, dtype=torch.float32,
                                      per_slot_offsets=True).layer(0)
    grid.offset = torch.tensor([9, 2], dtype=torch.int32)
    before = grid.k.clone()
    attention_apply(params, x[:2, :1].expand(2, 1, -1).contiguous(), cfg,
                    rope_cos=cos, rope_sin=sin, kv_cache=grid)
    changed = (grid.k != before).any(-1).any(-1)
    assert changed[0].nonzero().flatten().tolist() == [9 % 4]
    assert changed[1].nonzero().flatten().tolist() == [2]
    with pytest.raises(ValueError, match="verify"):
        attention_apply(params, x[:2, :2].expand(2, 2, -1).contiguous(), cfg,
                        rope_cos=cos, rope_sin=sin, kv_cache=grid)


@pytest.mark.parametrize("kw", [
    dict(speculative_k=2), dict(prefill_chunk=16),
    dict(enable_prefix_cache=True), dict(preemption=True, priority_levels=2),
    dict(kv_block_size=16, block_native_attn=True), dict(kv_block_size=12),
    dict(kv_block_size=16), dict(engine_step_timeout_s=2.0),
    dict(engine_step_timeout_s=0.0)])
def test_validate_rolling_exclusions_match_jax(kw):
    """Each config is refused by both packages or by neither."""
    jcfg = jconfig.llama2_config("tiny", attention_impl="flash",
                                 sliding_window=32)
    tcfg = tconfig.llama2_config("tiny", attention_impl="flash",
                                 sliding_window=32)
    try:
        jconfig.ServingConfig(max_len=64, **kw).validate(jcfg)
        jax_ok = True
    except AssertionError:
        jax_ok = False
    try:
        ServingConfig(max_len=64, **kw).validate(tcfg)
        port = "ok"
    except ValueError:
        port = "refused"
    assert port == ("ok" if jax_ok else "refused"), (kw, jax_ok, port)
