"""The port's host-RAM KV tier against the JAX package's.

- serving/host_tier.py: HostKVTier against the JAX HostKVTier on the same
  arrays and the same operations (byte budget, LRU eviction, sequence
  dedup, block-aligned lookups, a corrupt entry dropped at restore, an
  oversized entry refused), with equal checksums; bf16 blocks travel as
  their int16 bits and hash like JAX's bf16 arrays.
- SlotKVPool.gather_blocks_host and host_blocks_to_sub bit-exact against
  JAX's on the same arena, fp32 and int8, padded to the region and not;
  a bf16 arena's round trip is bit for bit.
- The eviction hook: it fires before the unref, a failing demotion is
  printed while eviction proceeds, and a full drop (`drop_retained`)
  stays silent.
- The engine (block-native, fp32 compute) against the JAX engine (its
  Pallas kernel in interpret mode) on tiny Llama: a prefix demoted by
  retained-entry churn restores from the host with JAX's greedy tokens and
  logprobs (1e-4) and equal host_tier_* counters; a corrupted entry is a
  checksum miss whose tokens equal the tier-off engine's; the tier off is
  identical to an engine without one; int8 pools and a restart keep the
  tier working.
"""
import time

import jax
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
from megatron_tpu.serving import host_tier as jtier
from megatron_tpu.serving import kv_pool as jkv
from megatron_tpu.training.checkpointing import _flatten
from megatron_tpu_torch import config as tconfig
from megatron_tpu_torch.config import ServingConfig
from megatron_tpu_torch.convert.from_jax import params_from_numpy
from megatron_tpu_torch.inference.generation import Generator, SamplingParams
from megatron_tpu_torch.models.language_model import LanguageModel
from megatron_tpu_torch.resilience import faults
from megatron_tpu_torch.serving import (HostKVTier, SamplingOptions,
                                        ServingEngine)
from megatron_tpu_torch.serving import host_tier as ttier
from megatron_tpu_torch.serving import kv_pool as tkv

torch.set_num_threads(2)
TOL = 1e-4
PREFIX = list(range(2, 20))  # 18 tokens: one whole 16-token block
NEW = 6
GREEDY = SamplingOptions(temperature=0.0)
TIER = dict(num_slots=2, max_queue=32, max_len=64, enable_prefix_cache=True,
            kv_block_size=16, block_native_attn=True, retained_slots=1)


def _mk(seed, dtype=np.float32):
    return {"k": np.full((2, 1, 4, 2, 8), seed, dtype),
            "v": np.full((2, 1, 4, 2, 8), seed, dtype)}


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_tier_unit_matches_jax(dtype):
    ours, ref = HostKVTier(3000, 4), jtier.HostKVTier(3000, 4)
    big = {"k": np.zeros((2, 1, 64, 2, 64), dtype),
           "v": np.zeros((2, 1, 64, 2, 64), dtype)}
    steps = [
        ("demote", ("a", list(range(8)), 5, 1)),
        ("demote", ("b", list(range(100, 108)), 5, 2)),
        # a third entry evicts the LRU one ("a") from the 3,000-byte budget
        ("demote", ("c", list(range(200, 208)), 5, 3)),
        ("lookup", (list(range(100, 108)), 7)),
        ("lookup", (list(range(8)), 7)),
        ("restore", ("b",)),
        ("corrupt", ("c",)),
        ("restore", ("c",)),
        ("huge", ()),
        # the same sequence demoted under a new key replaces the old entry
        ("demote", ("b2", list(range(100, 108)), 5, 4)),
        ("drop", ("c",)),
        ("drop", ("b2",)),
    ]
    for name, args in steps:
        if name == "demote":
            key, toks, length, seed = args
            got = [t.demote(key, toks, length, _mk(seed, dtype))
                   for t in (ours, ref)]
        elif name == "corrupt":
            for t in (ours, ref):
                t._entries[args[0]].arrays["k"].view(np.uint8).flat[0] ^= 0xFF
            got = [None, None]
        elif name == "restore":
            got = [None if e is None else (e.key, e.crc, e.length)
                   for e in (t.restore(*args) for t in (ours, ref))]
        elif name == "huge":
            got = [t.demote("huge", list(range(8)), 5, big)
                   for t in (ours, ref)]
        else:
            got = [getattr(t, name)(*args) for t in (ours, ref)]
        assert got[0] == got[1], (name, got)
        assert len(ours) == len(ref) and ours.bytes_used == ref.bytes_used
        assert [(k, e.crc, e.nbytes) for k, e in ours._entries.items()] == \
            [(k, e.crc, e.nbytes) for k, e in ref._entries.items()]
        for key in ("a", "b", "c", "b2"):
            assert ours.has(key) == ref.has(key), (name, key)


def test_checksum_of_bf16_bits_matches_jax():
    """The port hands bf16 blocks over as their int16 bits; the CRC over
    those bytes is JAX's CRC over its bf16 arrays."""
    x = torch.randn(2, 3, 4, 2, 8).to(torch.bfloat16)
    bits = tkv._to_host(x)
    assert bits.dtype == np.int16
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    assert ttier._checksum({"k": bits, "v": bits}) == jtier._checksum(
        {"k": np.asarray(jx), "v": np.asarray(jx)})
    back = tkv._from_host(bits, torch.bfloat16, "cpu")
    assert torch.equal(back.view(torch.int16), x.view(torch.int16))


def _pools(dtype):
    tcfg = tconfig.llama2_config("tiny", num_layers=2, hidden_size=64,
                                 num_attention_heads=4, num_kv_heads=2)
    jcfg = jconfig.llama2_config("tiny", num_layers=2, hidden_size=64,
                                 num_attention_heads=4, num_kv_heads=2)
    quant = dtype == "int8"
    ours = tkv.SlotKVPool(tcfg, 3, 64, block_size=16, device="cpu",
                          dtype=torch.int8 if quant else torch.float32)
    ref = jkv.SlotKVPool(jcfg, 3, 64, block_size=16,
                         dtype=jnp.int8 if quant else jnp.float32)
    rs = np.random.RandomState(5)
    shape = tuple(ours.caches.arena.k.shape)
    arrays = {}
    for name in ("k", "v"):
        arrays[name] = (rs.randint(-127, 128, shape).astype(np.int8) if quant
                        else rs.standard_normal(shape).astype(np.float32))
    if quant:
        for name in ("k_scale", "v_scale"):
            arrays[name] = rs.rand(*shape[:-1], 1).astype(np.float32)
    for name, a in arrays.items():
        getattr(ours.caches.arena, name).copy_(torch.from_numpy(a))
    ref.caches = ref.caches._replace(arena=ref.caches.arena._replace(
        **{name: jnp.asarray(a) for name, a in arrays.items()}))
    return ours, ref


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_gather_and_restore_match_jax(dtype):
    ours, ref = _pools(dtype)
    blocks = [4, 0, 2]
    got, want = ours.gather_blocks_host(blocks), ref.gather_blocks_host(blocks)
    assert sorted(got) == sorted(want)
    for name in got:
        assert got[name].dtype == want[name].dtype
        np.testing.assert_array_equal(got[name], want[name])
    for pad in (True, False):
        sub = ours.host_blocks_to_sub(got, 40, pad_to_cap=pad)
        jsub = ref.host_blocks_to_sub(want, 40, pad_to_cap=pad)
        assert sub.offset == 40
        for name in ("k", "v", "k_scale", "v_scale"):
            a, b = getattr(sub, name), getattr(jsub, name)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_bf16_gather_restore_bit_exact():
    tcfg = tconfig.llama2_config("tiny", num_layers=2, hidden_size=64,
                                 num_attention_heads=4, num_kv_heads=2)
    pool = tkv.SlotKVPool(tcfg, 2, 64, block_size=16, device="cpu",
                          dtype=torch.bfloat16)
    pool.caches.arena.k.copy_(torch.randn_like(pool.caches.arena.k,
                                               dtype=torch.float32))
    host = pool.gather_blocks_host([3, 1])
    assert host["k"].dtype == np.int16
    sub = pool.host_blocks_to_sub(host, 32)
    assert sub.k.dtype == torch.bfloat16 and sub.k.shape[2] == pool.cap
    want = pool.caches.arena.k[:, [3, 1]].reshape(2, 1, 32, *sub.k.shape[3:])
    assert torch.equal(sub.k[:, :, :32].view(torch.int16),
                       want.view(torch.int16))
    assert not sub.k[:, :, 32:].any()


def test_eviction_hook_order_failure_and_full_drop(caplog):
    tcfg = tconfig.llama2_config("tiny", num_layers=2, hidden_size=64,
                                 num_attention_heads=4, num_kv_heads=2)
    pool = tkv.SlotKVPool(tcfg, 3, 64, block_size=16, device="cpu",
                          dtype=torch.float32, retained_limit=1)
    seen = []

    def hook(ent):
        # the entry still pins its blocks while the hook runs
        seen.append((ent.key, [pool.block_refcount(b) for b in ent.blocks]))
        if len(seen) == 2:
            raise RuntimeError("host copy failed")

    pool.on_evict_entry = hook
    keys = []
    for slot_len in (20, 33, 40):
        slot, _ = pool.alloc_row()
        keys.append(pool.retain_row(slot, slot_len, list(range(slot_len))))
    # two evictions past the limit of 1; the second demotion raised and
    # was printed, and its eviction still freed the entry
    assert [k for k, _ in seen] == keys[:2]
    assert all(rc == [1] * len(rc) for _, rc in seen)
    assert "on_evict_entry failed" in caplog.text
    assert pool.retained_count() == 1
    assert pool.drop_retained() == 1 and len(seen) == 2
    assert pool.on_evict_entry is hook


@pytest.fixture(scope="module")
def tiny():
    kw = dict(attention_impl="flash", compute_dtype="float32")
    jcfg = jconfig.llama2_config("tiny", **kw)
    tcfg = tconfig.llama2_config("tiny", **kw)
    params = jlm.model_init(jax.random.PRNGKey(0), jcfg)
    model = LanguageModel.from_state_dict(
        tcfg, params_from_numpy(_flatten(params), tcfg, device="cpu"))
    return jcfg, params, tcfg, model


def _scenario(submit, corrupt=None):
    """A prefix, two fillers that push it out of the retained limit (and,
    with the tier on, demote it), then a prompt extending the prefix."""
    out = [submit(PREFIX, NEW).result(timeout=600)]
    for base in (40, 50):
        out.append(submit([base, base + 1, base + 2], 2).result(timeout=600))
    if corrupt is not None:
        corrupt()
    out.append(submit(PREFIX + [90, 91], NEW).result(timeout=600))
    return out


_COUNTERS = ("host_tier_demotions", "host_tier_hits",
             "host_tier_checksum_misses", "prefix_hits",
             "prefill_tokens_saved")


def _flip_long_entries(tier):
    for ent in tier._entries.values():
        if ent.length >= 16:
            ent.arrays["k"].view(np.uint8).flat[0] ^= 0xFF


@pytest.mark.parametrize("corrupt", [False, True], ids=["restore", "corrupt"])
def test_engine_demote_restore_matches_jax(tiny, corrupt):
    jcfg, params, tcfg, model = tiny
    kw = dict(TIER, host_kv_bytes=1 << 22)
    jeng = JServingEngine(JGenerator(params, jcfg, eos_id=0, pad_id=0),
                          jconfig.ServingConfig(**kw))
    try:
        want = _scenario(
            lambda p, n: jeng.submit(p, n, JSamplingOptions(temperature=0.0)),
            (lambda: _flip_long_entries(jeng._host_tier)) if corrupt
            else None)
        jsnap = jeng.metrics.snapshot()
    finally:
        jeng.close()
    gen = Generator(model, tcfg, eos_id=0, pad_id=0, device="cpu")
    with ServingEngine(gen, ServingConfig(**kw), device="cpu") as eng:
        got = _scenario(lambda p, n: eng.submit(p, n, GREEDY),
                        (lambda: _flip_long_entries(eng._host_tier))
                        if corrupt else None)
        snap = eng.metrics.snapshot()
    for (gt, glp), (wt, wlp) in zip(got, want):
        assert gt == wt
        np.testing.assert_allclose(glp, wlp, rtol=TOL, atol=TOL)
    for key in _COUNTERS:
        assert snap[key] == jsnap[key], key
    assert snap["host_tier_demotions"] >= 1
    if corrupt:
        assert snap["host_tier_checksum_misses"] >= 1
        assert snap["host_tier_hits"] == 0
    else:
        assert snap["host_tier_hits"] >= 1
    # and the serial route's tokens
    toks, lens, _ = gen.generate([PREFIX + [90, 91]], NEW,
                                 SamplingParams(temperature=0.0))
    assert got[-1][0] == toks[0, :lens[0]].tolist()


@pytest.mark.parametrize("kv", [None, "int8"], ids=["fp32", "int8"])
def test_tier_off_identical_and_corrupt_is_a_miss(tiny, kv):
    """host_kv_bytes 0 builds no tier and counts nothing; the tier on, a
    clean restore and a corrupted entry (flipped by the fault harness's
    serve_host_corrupt at the engine's step) all give the tier-off
    tokens."""
    _, _, tcfg, model = tiny
    gen = Generator(model, tcfg, eos_id=0, pad_id=0, device="cpu",
                    kv_cache_dtype=torch.float32)
    outs, snaps = {}, {}
    for arm in ("off", "on", "corrupt"):
        kw = dict(TIER, kv_dtype=kv,
                  host_kv_bytes=0 if arm == "off" else 1 << 22)
        inj = faults.FaultInjector(serve_host_corrupt_calls={1})
        with ServingEngine(gen, ServingConfig(**kw), device="cpu") as eng:

            def step_once():
                # one engine step between the fillers and the hit (a
                # prompt sharing nothing with the prefix); in the corrupt
                # arm it flips the largest demoted entry, the prefix's
                if arm == "corrupt":
                    faults.activate(inj)
                try:
                    eng.generate([60, 61, 62], 1, GREEDY, timeout=60)
                finally:
                    faults.deactivate()

            outs[arm] = [t for t, _ in _scenario(
                lambda p, n: eng.submit(p, n, GREEDY), step_once)]
            snaps[arm] = eng.metrics.snapshot()
            assert (eng._host_tier is None) == (arm == "off")
        assert bool(inj.fired) == (arm == "corrupt")
    assert outs["off"] == outs["on"] == outs["corrupt"]
    assert all(snaps["off"][k] == 0 for k in _COUNTERS[:3])
    assert snaps["on"]["host_tier_hits"] >= 1
    assert snaps["corrupt"]["host_tier_checksum_misses"] >= 1
    assert snaps["corrupt"]["host_tier_hits"] == 0


def test_restart_rewires_the_tier(tiny):
    """A crashed step rebuilds the pool; the tier survives it and the new
    pool's evictions still demote to it."""
    _, _, tcfg, model = tiny
    gen = Generator(model, tcfg, eos_id=0, pad_id=0, device="cpu")
    with ServingEngine(gen, ServingConfig(**dict(TIER, host_kv_bytes=1 << 22)),
                       device="cpu") as eng:
        eng.generate([7, 8, 9], 2, GREEDY)
        tier, old_pool = eng._host_tier, eng.pool
        inj = faults.FaultInjector(serve_crash_calls={1})
        faults.activate(inj)
        try:
            with pytest.raises(RuntimeError):
                eng.generate([30, 31, 32], 4, GREEDY, timeout=60)
        finally:
            faults.deactivate()
        give_up = time.monotonic() + 30
        while eng.pool is None or eng.pool is old_pool:  # the rebuild
            assert time.monotonic() < give_up
            time.sleep(0.01)
        assert eng._host_tier is tier
        assert eng.pool.on_evict_entry == eng._demote_entry
        got = _scenario(lambda p, n: eng.submit(p, n, GREEDY))
        snap = eng.metrics.snapshot()
    assert snap["engine_restarts"] == 1 and snap["host_tier_hits"] >= 1
    toks, lens, _ = gen.generate([PREFIX + [90, 91]], NEW,
                                 SamplingParams(temperature=0.0))
    assert got[-1][0] == toks[0, :lens[0]].tolist()
