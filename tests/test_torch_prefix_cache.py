"""The port's prefix cache: the trie, the retained pool and the engine.

- serving/prefix_index.py against the JAX package's PrefixIndex on one
  random sequence of inserts, removes and lookups (with namespaces).
- SlotKVPool retention and sharing against the JAX pool on the same
  operations: block mode (aliasing, retain_row, LRU eviction under block
  pressure, free_count with mutually aliased entries, refcounts, gauges)
  and whole-region mode (retain, touch, alloc(exclude=...)).
- slice_slot / slice_blocks / insert_blocks(pfx_blocks) against JAX's on
  the same numpy arenas, fp32 and int8.
- The engine with the prefix cache on against the JAX ServingEngine, both
  block-native (the JAX one in Pallas interpret mode), on tiny Llama and
  Falcon with fp32 compute: a request, then three sharing its prefix, then
  one continuing a finished sequence (a retained hit). Greedy tokens
  exact, logprobs within 1e-4, the same hits and saved tokens.
- Inside the port: cache on equals cache off on the whole-region pool,
  the bracketed block pool, an int8 pool and a rolling block pool (whose
  hits pass the ring-validity gate and forward their suffix one token a
  step).
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu import config as jconfig
from megatron_tpu.inference.generation import Generator as JGenerator
from megatron_tpu.models import language_model as jlm
from megatron_tpu.models.attention import KVCache as JKVCache
from megatron_tpu.serving import SamplingOptions as JSamplingOptions
from megatron_tpu.serving import ServingEngine as JServingEngine
from megatron_tpu.serving import kv_pool as jkv
from megatron_tpu.serving.prefix_index import PrefixIndex as JPrefixIndex
from megatron_tpu.training.checkpointing import _flatten
import jax
from megatron_tpu_torch import config as tconfig
from megatron_tpu_torch.config import ServingConfig
from megatron_tpu_torch.convert.from_jax import params_from_numpy
from megatron_tpu_torch.inference.generation import Generator
from megatron_tpu_torch.models.attention import KVCache
from megatron_tpu_torch.models.language_model import LanguageModel
from megatron_tpu_torch.serving import SamplingOptions, ServingEngine
from megatron_tpu_torch.serving import kv_pool as tkv
from megatron_tpu_torch.serving.prefix_index import PrefixIndex

torch.set_num_threads(2)
TOL = 1e-4
PRESETS = {"llama": "llama2_config", "falcon": "falcon_config"}
PREFIX = list(range(100, 140))  # 2.5 blocks of 16: hits floor to 32
NEW = 8
GREEDY = SamplingOptions(temperature=0.0)


def _models(name, **extra):
    fn = PRESETS[name]
    kw = dict(attention_impl="flash", compute_dtype="float32", **extra)
    jcfg = getattr(jconfig, fn)("tiny", **kw)
    tcfg = getattr(tconfig, fn)("tiny", **kw)
    params = jlm.model_init(jax.random.PRNGKey(0), jcfg)
    model = LanguageModel.from_state_dict(
        tcfg, params_from_numpy(_flatten(params), tcfg, device="cpu"))
    return jcfg, params, tcfg, model


def _staged(submit):
    """A request, then three sharing its prefix (running or retained
    sources), then one continuing the first's finished sequence."""
    first = submit(PREFIX + [5, 6, 7], NEW).result(timeout=600)
    rest = [submit(PREFIX + [8 + i, 9, 10 + i], NEW) for i in range(3)]
    rest = [r.result(timeout=600) for r in rest]
    cont = submit(first[0] + [11, 12], NEW).result(timeout=600)
    return [first] + rest + [cont]


def test_prefix_index_matches_jax():
    rng = random.Random(0)
    ours, ref = PrefixIndex(4), JPrefixIndex(4)
    seqs = {}
    for step in range(300):
        op = rng.random()
        ns = rng.choice([None, "a"])
        if op < 0.4:
            key = rng.choice([rng.randrange(6), ("ret", rng.randrange(4))])
            toks = [rng.randrange(3) for _ in range(rng.randrange(0, 20))]
            seqs[key] = toks
            ours.insert(key, toks, namespace=ns)
            ref.insert(key, toks, namespace=ns)
        elif op < 0.55 and seqs:
            key = rng.choice(sorted(seqs, key=repr))
            ours.remove(key)
            ref.remove(key)
        else:
            toks = [rng.randrange(3) for _ in range(rng.randrange(0, 20))]
            cap = rng.choice([None, max(len(toks) - 1, 0)])
            assert ours.lookup(toks, cap, namespace=ns) == \
                ref.lookup(toks, cap, namespace=ns), step
        assert len(ours) == len(ref)


def _pool_pair(block_size, retained_limit=None, **kw):
    tcfg = tconfig.llama2_config("tiny", num_layers=2, hidden_size=64,
                                 num_attention_heads=4, num_kv_heads=2)
    jcfg = jconfig.llama2_config("tiny", num_layers=2, hidden_size=64,
                                 num_attention_heads=4, num_kv_heads=2)
    ours = tkv.SlotKVPool(tcfg, 3, 64, dtype=torch.float32,
                          block_size=block_size,
                          retained_limit=retained_limit, device="cpu", **kw)
    ref = jkv.SlotKVPool(jcfg, 3, 64, dtype=jnp.float32,
                         retained_limit=retained_limit,
                         block_size=block_size)
    for p in (ours, ref):
        p.reclaimed = []
        p.on_reclaim = p.reclaimed.append
    return ours, ref


def _same_block_state(ours, ref):
    a, b = ours.accounting(), ref.accounting()
    np.testing.assert_array_equal(a["rc"], b["rc"])
    np.testing.assert_array_equal(a["map"], b["map"])
    assert a["free_blocks"] == b["free_blocks"]
    assert a["free_rows"] == b["free_rows"]
    # blocks, length and prefix namespace of every retained entry
    assert a["retained"] == b["retained"]
    assert ours.free_count() == ref.free_count()
    assert ours.shared_block_count() == ref.shared_block_count()
    assert ours.reclaimed == ref.reclaimed
    lengths = [20, 0, 33]
    assert ours.kv_gauges(lengths) == ref.kv_gauges(lengths)


@pytest.mark.parametrize("retained_limit", [None, 2])
def test_block_retention_matches_jax(retained_limit):
    ours, ref = _pool_pair(16, retained_limit)
    calls = [
        ("alloc_row", ()), ("alloc_row", ()),
        ("retain_row", (0, 20, list(range(20)))),
        # a hit aliasing the retained entry's first block
        ("alloc_alias", ("ret", 0), 1),
        ("retain_row", (1, 40, list(range(40)))),
        ("retain_row", (2, 33, list(range(33)))),
        ("alloc_row", ()), ("alloc_row", ()),
        ("drop_retained", ()),
    ]
    for call in calls:
        if call[0] == "alloc_alias":
            got = []
            for p in (ours, ref):
                ent = p.entry(call[1])
                alias = ent.blocks[:call[2]] if ent is not None else []
                got.append(p.alloc_row(alias=alias))
            assert got[0] == got[1]
        else:
            assert getattr(ours, call[0])(*call[1]) == \
                getattr(ref, call[0])(*call[1]), call
        _same_block_state(ours, ref)


def test_whole_region_retention_matches_jax():
    ours, ref = _pool_pair(None, retained_limit=2)
    for name, args in (("alloc", ()), ("alloc", ()), ("alloc", ()),
                       ("retain", (1,)), ("retain", (0,)), ("touch", (1,)),
                       ("alloc", ()), ("retain", (2,)),
                       ("alloc", ((2,),)), ("release", (0,)),
                       ("alloc", ()), ("alloc", ())):
        assert getattr(ours, name)(*args) == getattr(ref, name)(*args), name
        assert ours.free_count() == ref.free_count()
        assert ours.retained_count() == ref.retained_count()
        assert ours.reclaimed == ref.reclaimed
        assert ours.kv_gauges([3, 4, 5]) == ref.kv_gauges([3, 4, 5])


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_slice_and_insert_match_jax(dtype):
    rs = np.random.RandomState(1)
    L, T, B, nkv, hd, S, nb = 2, 9, 4, 2, 8, 2, 4
    quant = dtype == "int8"

    def arr(shape):
        if quant:
            return rs.randint(-127, 128, shape).astype(np.int8)
        return rs.standard_normal(shape).astype(np.float32)

    k, v = arr((L, T, B, nkv, hd)), arr((L, T, B, nkv, hd))
    ks, vs = (rs.rand(L, T, B, nkv, 1).astype(np.float32) if quant
              else None for _ in range(2))
    bmap = np.array([[3, 0, 5, 7], [1, 2, 4, 6]], np.int32)
    sub_k, sub_v = arr((L, 1, nb * B, nkv, hd)), arr((L, 1, nb * B, nkv, hd))
    sub_ks, sub_vs = (rs.rand(L, 1, nb * B, nkv, 1).astype(np.float32)
                      if quant else None for _ in range(2))

    def tk(x):
        return None if x is None else torch.from_numpy(x.copy())

    def jx(x):
        return None if x is None else jnp.asarray(x)

    ours = tkv.BlockKV(KVCache(tk(k), tk(v), torch.zeros(S, dtype=torch.int32),
                               tk(ks), tk(vs)), torch.from_numpy(bmap))
    ref = jkv.BlockKV(JKVCache(jx(k), jx(v), jnp.zeros((L, S), jnp.int32),
                               jx(ks), jx(vs)), jnp.asarray(bmap))
    blocks = [5, 0, 2]
    got = tkv.slice_blocks(ours, blocks, 7)
    want = jkv.slice_blocks(ref, jnp.asarray(blocks, jnp.int32), 7)
    for name in ("k", "v", "k_scale", "v_scale"):
        if getattr(got, name) is not None:
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)))
    assert got.offset == 7
    # a copy: a later write to the arena does not reach it
    ours.arena.k[:, 5] = 0
    np.testing.assert_array_equal(got.k.numpy()[:, 0, :B], k[:, 5])
    ours.arena.k[:, 5] = torch.from_numpy(k[:, 5])
    tsub = KVCache(tk(sub_k), tk(sub_v), 0, tk(sub_ks), tk(sub_vs))
    jsub = JKVCache(jx(sub_k), jx(sub_v), jnp.zeros((L,), jnp.int32),
                    jx(sub_ks), jx(sub_vs))
    for pfx in (0, 2):
        tkv.insert_blocks(ours, tsub, 1, 13, pfx)
        ref = jkv.insert_blocks(ref, jsub, 1, 13, pfx)
        # JAX sends the aliased blocks' writes to its trash block (the
        # last); the port skips them
        for name in ("k", "v", "k_scale", "v_scale"):
            g = getattr(ours.arena, name)
            if g is not None:
                np.testing.assert_array_equal(
                    g.numpy()[:, :T - 1],
                    np.asarray(getattr(ref.arena, name))[:, :T - 1])
        assert int(ours.arena.offset[1]) == int(ref.arena.offset[0, 1]) == 13
    # whole-region slice
    region = KVCache(tk(sub_k[:, 0][:, None].repeat(S, 1)),
                     tk(sub_v[:, 0][:, None].repeat(S, 1)),
                     torch.zeros(S, dtype=torch.int32),
                     *(None if x is None else tk(x[:, 0][:, None].repeat(S, 1))
                       for x in (sub_ks, sub_vs)))
    jregion = JKVCache(*(jx(x[:, 0][:, None].repeat(S, 1))
                         for x in (sub_k, sub_v)),
                       jnp.zeros((L, S), jnp.int32),
                       *(None if x is None else jx(x[:, 0][:, None].repeat(S, 1))
                         for x in (sub_ks, sub_vs)))
    got = tkv.slice_slot(region, 1, 5)
    want = jkv.slice_slot(jregion, 1, 5)
    np.testing.assert_array_equal(got.k.numpy(), np.asarray(want.k))
    assert got.k.data_ptr() != region.k.data_ptr()
    tkv.clone_prefix(region, 1, 0, 9)
    jregion = jkv.clone_prefix(jregion, 1, 0, 9)
    for name in ("k", "v", "k_scale", "v_scale"):
        if getattr(region, name) is not None:
            np.testing.assert_array_equal(
                getattr(region, name).numpy(),
                np.asarray(getattr(jregion, name)))
    assert int(region.offset[0]) == int(jregion.offset[0, 0]) == 9


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_prefix_engine_matches_jax_engine(name):
    jcfg, params, tcfg, model = _models(name)
    kw = dict(num_slots=3, max_len=128, kv_block_size=16,
              block_native_attn=True, enable_prefix_cache=True)
    jeng = JServingEngine(JGenerator(params, jcfg, eos_id=0, pad_id=0),
                          jconfig.ServingConfig(**kw))
    try:
        want = _staged(lambda p, n: jeng.submit(
            p, n, JSamplingOptions(temperature=0.0)))
        jsnap = jeng.metrics.snapshot()
    finally:
        jeng.close()
    gen = Generator(model, tcfg, eos_id=0, pad_id=0, device="cpu")
    with ServingEngine(gen, ServingConfig(**kw), device="cpu") as eng:
        got = _staged(lambda p, n: eng.submit(p, n, GREEDY))
        snap = eng.metrics.snapshot()
        assert eng.health()["kv_blocks_retained"] > 0
    for (gt, glp), (wt, wlp) in zip(got, want):
        assert gt == wt
        np.testing.assert_allclose(glp, wlp, rtol=TOL, atol=TOL)
    for key in ("prefix_hits", "prefill_tokens_saved", "prefix_hit_tokens"):
        assert snap[key] == jsnap[key], key
    assert snap["prefix_hits"] >= 4


@pytest.fixture(scope="module")
def llama():
    _, _, tcfg, model = _models("llama")
    return tcfg, model


@pytest.mark.parametrize("kw", [
    dict(),  # whole-region: slot copies, retained slots park at length
    dict(kv_block_size=16),  # bracketed block pool
    dict(kv_block_size=16, block_native_attn=True, kv_dtype="int8"),
], ids=["region", "bracketed", "int8"])
def test_cache_on_equals_cache_off(llama, kw):
    tcfg, model = llama
    gen = Generator(model, tcfg, eos_id=0, pad_id=0, device="cpu",
                    kv_cache_dtype=torch.float32)
    outs, snaps = [], []
    for on in (False, True):
        with ServingEngine(gen, ServingConfig(num_slots=3, max_len=128,
                                              enable_prefix_cache=on, **kw),
                           device="cpu") as eng:
            outs.append([t for t, _ in _staged(
                lambda p, n: eng.submit(p, n, GREEDY))])
            snaps.append(eng.metrics.snapshot())
            # the routing hint: two whole blocks of the shared prefix
            assert eng.prefix_peek(PREFIX + [99, 98]) == (32 if on else 0)
    assert outs[0] == outs[1]
    assert snaps[1]["prefix_hits"] >= 3 and snaps[0]["prefix_hits"] == 0
    assert (snaps[1]["prefill_forward_tokens"]
            < snaps[0]["prefill_forward_tokens"])


def test_rolling_block_pool_continuation_hits():
    """A sliding-window model whose window (32) is below max_len: the
    continuation of a finished sequence hits it at its exact length (the
    ring copied whole, the suffix one token a step) and gives the tokens
    of the cache-off engine."""
    _, _, tcfg, model = _models("llama", sliding_window=32)
    gen = Generator(model, tcfg, eos_id=0, pad_id=0, device="cpu",
                    kv_cache_dtype=torch.float32)
    outs, snaps = [], []
    for on in (False, True):
        with ServingEngine(gen, ServingConfig(
                num_slots=2, max_len=96, kv_block_size=16,
                enable_prefix_cache=on), device="cpu") as eng:
            assert eng.pool.rolling
            first = eng.submit(PREFIX[:20], NEW, GREEDY).result(timeout=60)
            cont = eng.submit(first[0] + [3, 4, 5], NEW,
                              GREEDY).result(timeout=60)
            outs.append([first[0], cont[0]])
            snaps.append(eng.metrics.snapshot())
    assert outs[0] == outs[1]
    assert snaps[1]["prefix_hits"] == 1
    assert snaps[1]["prefill_tokens_saved"] == len(PREFIX[:20]) + NEW
    # the suffix forwards one token a step on the ring
    assert snaps[1]["prefill_chunks"] == 3
