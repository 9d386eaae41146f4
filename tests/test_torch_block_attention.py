"""The port's block-native decode attention against the JAX package's Pallas
kernel (`block_native_attention(..., interpret=True)`) on the same numpy
inputs, and the block pool that feeds it.

On the CPU the port's `block_native_attention` is its plain version (the
Hopper kernel runs on the card, held against the plain version by
chip_smoke.py); the kernel's split-KV layout (`split_plan`) and the merge of
its splits (an fp32 numpy emulation) are held here against the JAX kernel.
Tolerances: fp32 1e-5 (the same fp32 softmax, summed in
another order), bf16 1e-2 (one bf16 rounding of the output), int8 with
scales 1e-5 (dequantized in fp32 on both sides, fp32 queries)."""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu.ops.block_attention_pallas import \
    block_native_attention as jax_block_attention
from megatron_tpu_torch import config as tconfig
from megatron_tpu_torch.models.attention import KVCache
from megatron_tpu_torch.ops import block_attention_cuda
from megatron_tpu_torch.ops.block_attention import block_native_attention
from megatron_tpu_torch.serving.kv_pool import (SlotKVPool,
                                                block_native_cache,
                                                insert_blocks, insert_prefill,
                                                pack_block_native)

torch.set_num_threads(2)
TOL = {"float32": 1e-5, "bfloat16": 1e-2, "int8": 1e-5}


def _case(seed, *, S, w, nq, nkv, B, nb, dtype, hd=16, idle=(),
          lengths=None):
    """Inputs in numpy: a permuted (scattered) physical map with the last
    block as trash, per-slot lengths whose window fits the region (partial
    tail blocks), idle rows at length 0 with an all-trash map."""
    rs = np.random.RandomState(seed)
    T = S * nb + 1
    bmap = rs.permutation(T - 1)[:S * nb].reshape(S, nb).astype(np.int32)
    if lengths is None:
        lengths = rs.randint(1, nb * B - w + 1, S)
    lengths = np.asarray(lengths, np.int32)
    for s in idle:
        bmap[s] = T - 1
        lengths[s] = 0
    q = rs.randn(S, w, nq, hd).astype(np.float32)
    ks = vs = None
    if dtype == "int8":
        ka = rs.randint(-127, 127, (T, B, nkv, hd)).astype(np.int8)
        va = rs.randint(-127, 127, (T, B, nkv, hd)).astype(np.int8)
        ks = rs.rand(T, B, nkv, 1).astype(np.float32) * 0.02
        vs = rs.rand(T, B, nkv, 1).astype(np.float32) * 0.02
    else:
        ka = rs.randn(T, B, nkv, hd).astype(np.float32)
        va = rs.randn(T, B, nkv, hd).astype(np.float32)
    return q, ka, va, bmap, lengths, ks, vs


CASES = {
    # name: (S, w, nq, nkv, B, nb, dtype, idle rows)
    "decode_mha_b8": (4, 1, 4, 4, 8, 6, "float32", ()),
    "decode_gqa_b8": (4, 1, 4, 2, 8, 6, "float32", ()),
    "decode_mqa_b16": (4, 1, 4, 1, 16, 4, "float32", ()),
    "verify_w3_gqa_b16": (3, 3, 4, 2, 16, 4, "float32", ()),
    "verify_w3_mqa_b8": (3, 3, 4, 1, 8, 6, "float32", ()),
    "idle_rows_decode": (4, 1, 4, 2, 8, 6, "float32", (1, 3)),
    "idle_rows_verify": (4, 3, 4, 4, 16, 4, "float32", (0, 2)),
    "bf16_decode_gqa": (4, 1, 4, 2, 16, 4, "bfloat16", ()),
    "bf16_verify_mha": (3, 3, 4, 4, 8, 6, "bfloat16", (2,)),
    "int8_decode_gqa": (4, 1, 4, 2, 8, 6, "int8", ()),
    "int8_verify_mqa": (3, 3, 4, 1, 16, 4, "int8", (1,)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_block_attention_matches_jax_kernel(name):
    S, w, nq, nkv, B, nb, dtype, idle = CASES[name]
    q, ka, va, bmap, lengths, ks, vs = _case(
        sorted(CASES).index(name), S=S, w=w, nq=nq, nkv=nkv, B=B, nb=nb,
        dtype=dtype, idle=idle)
    scale = q.shape[-1] ** -0.5
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    want = jax_block_attention(
        jnp.asarray(q, jdt), jnp.asarray(ka, jdt), jnp.asarray(va, jdt),
        jnp.asarray(bmap), jnp.asarray(lengths), scale=scale, block_size=B,
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs), interpret=True)
    tdt = torch.bfloat16 if dtype == "bfloat16" else None
    got = block_native_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(ka).to(tdt),
        torch.from_numpy(va).to(tdt), torch.from_numpy(bmap),
        torch.from_numpy(lengths), scale=scale, block_size=B,
        k_scale=None if ks is None else torch.from_numpy(ks),
        v_scale=None if vs is None else torch.from_numpy(vs))
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16"
                         else torch.float32)
    got = got.float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=0)


def test_dead_blocks_do_not_change_the_result():
    """Blocks past a slot's last live position hold other slots' KV or
    garbage; overwriting them with large garbage changes nothing."""
    q, ka, va, bmap, lengths, _, _ = _case(
        5, S=3, w=2, nq=4, nkv=2, B=8, nb=6, dtype="float32",
        lengths=[3, 17, 30])
    args = dict(scale=0.25, block_size=8)
    base = block_native_attention(
        torch.from_numpy(q), torch.from_numpy(ka), torch.from_numpy(va),
        torch.from_numpy(bmap), torch.from_numpy(lengths), **args)
    ka2, va2 = ka.copy(), va.copy()
    for s, n in enumerate(lengths):
        for j in range((n + 2 - 1) // 8 + 1, 6):
            ka2[bmap[s, j]] = 1e4
            va2[bmap[s, j]] = -1e4
    got = block_native_attention(
        torch.from_numpy(q), torch.from_numpy(ka2), torch.from_numpy(va2),
        torch.from_numpy(bmap), torch.from_numpy(lengths), **args)
    torch.testing.assert_close(got, base, rtol=0, atol=0)


def _tiny(**kw):
    return tconfig.llama2_config("tiny", num_layers=2, hidden_size=64,
                                 num_attention_heads=4, num_kv_heads=2,
                                 **kw)


def test_block_pool_accounting_and_trash_map():
    cfg = _tiny()
    pool = SlotKVPool(cfg, 3, 64, dtype=torch.float32, block_size=16,
                      device="cpu")
    assert pool.total_blocks == 3 * 4 + 1 and pool.TRASH == 12
    assert pool.caches.arena.k.shape == (2, 13, 16, 2, 16)
    assert (pool.caches.map == pool.TRASH).all()
    assert pool.free_count() == 3
    slot, blocks = pool.alloc_row()
    assert pool.map_row(slot) == blocks and pool.TRASH not in blocks
    assert pool.free_count() == 2
    # the device map is a copy: editing the host map does not reach it
    device_map = pool.caches.map
    pool._map[slot] = 0
    assert device_map[slot].tolist() == blocks
    pool._map[slot] = blocks
    # the model-facing view shares the arena; packing it back is the pool's
    view = block_native_cache(pool.caches)
    assert view.k is pool.caches.arena.k and view.map is pool.caches.map
    packed = pack_block_native(view, pool.caches.map)
    assert packed.arena.v is pool.caches.arena.v
    used, retained, wasted = pool.kv_gauges([20, 0, 0])
    assert (used, retained) == (4, 0)
    assert wasted == (64 - 20) * pool.bytes_per_token()
    pool.release_row(slot)
    assert (pool.caches.map == pool.TRASH).all()
    assert pool.free_count() == 3
    with pytest.raises(RuntimeError, match="double free"):
        pool.release_row(slot)
    # retention: a 20-token sequence pins its 2 covering blocks; the row
    # and its other 2 blocks free at once, and eviction unrefs the rest
    slot, blocks = pool.alloc_row()
    reclaimed = []
    pool.on_reclaim = reclaimed.append
    key = pool.retain_row(slot, 20, list(range(20)))
    assert [pool.block_refcount(b) for b in blocks] == [1, 1, 0, 0]
    assert pool.entry(key).blocks == blocks[:2]
    assert (pool.caches.map[slot] == pool.TRASH).all()
    assert pool.kv_gauges([0, 0, 0])[1] == 2
    assert pool.drop_retained() == 1 and reclaimed == [key]
    assert [pool.block_refcount(b) for b in blocks] == [0, 0, 0, 0]
    assert pool.free_count() == 3


def test_prefill_cache_is_sized_to_the_padded_prompt():
    """The prefill cache spans the padded prompt, not the region, and
    landing it writes exactly the positions it covers: through the map in
    block mode, into the slot's region otherwise."""
    cfg = _tiny()
    L, nkv, hd = 2, 2, 16
    for block_size in (16, None):
        pool = SlotKVPool(cfg, 2, 256, dtype=torch.float32,
                          block_size=block_size, device="cpu")
        sub = pool.make_prefill_caches(3, 48)
        assert sub.k.shape == (L, 3, 48, nkv, hd)
        one = KVCache(torch.randn(L, 1, 48, nkv, hd),
                      torch.randn(L, 1, 48, nkv, hd), 0)
        if block_size:
            slot, blocks = pool.alloc_row()
            insert_blocks(pool.caches, one, slot, 40)
            arena = pool.caches.arena
            got = torch.cat([arena.k[:, b] for b in blocks[:3]], dim=1)
            assert arena.offset[slot].item() == 40
            # blocks past the padded prompt are not written
            assert not arena.k[:, blocks[3]].any()
        else:
            slot = pool.alloc()
            insert_prefill(pool.caches, one, slot, 40)
            got = pool.caches.k[:, slot, :48]
            assert pool.caches.offset[slot].item() == 40
            assert not pool.caches.k[:, slot, 48:].any()
        torch.testing.assert_close(got, one.k[:, 0], rtol=0, atol=0)


# --- the Hopper kernel's split-KV layout (csrc/block_attn.cu) ---------------

NEG_INF = -1e30
MASK_CLAMP = -1e20  # the kernels' exponent clamp for fully masked rows


def _smoke_block_shapes():
    """(S, w, nq, nkv, nb, B) of chip_smoke.py's BLOCK_CASES, then the
    engine's decode shape (8 slots of Llama-2-7B, 2,048 positions in blocks
    of 16)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    shapes = [(S, w, nq, nkv, smoke.BLOCK_CAP // B, B)
              for _, S, w, nq, nkv, _, B, _, _, _ in smoke.BLOCK_CASES]
    return shapes + [(8, 1, 32, 32, 128, 16)]


@pytest.mark.parametrize("sms", [132, 114])
def test_split_plan_covers_every_key_once_and_fills_the_card(sms):
    shapes = _smoke_block_shapes()
    assert len(shapes) == 13
    for S, w, nq, nkv, nb, B in shapes:
        plan = block_attention_cuda.split_plan(S, w, nq, nkv, nb, B, sms)
        what = f"S {S} w {w} nq {nq} nkv {nkv} nb {nb} B {B}: {plan}"
        cap = nb * B
        # whole blocks a split, every key of the region in exactly one
        # split, in order
        assert plan.keys % B == 0 and plan.cap == cap, what
        keys = [k for i in range(plan.splits)
                for k in range(i * plan.keys, min((i + 1) * plan.keys, cap))]
        assert keys == list(range(cap)), what
        assert plan.keys * (plan.splits - 1) < cap <= plan.keys * plan.splits
        # the kernel's map entries a split (csrc/block_attn.cu MAP_MAX)
        assert plan.keys // B <= 512, what
        rows = nq // nkv * w
        assert plan.rows == (1 if rows == 1 else 8), what
        assert plan.chunks * plan.rows >= rows > (plan.chunks - 1) * plan.rows
        assert plan.blocks == S * nkv * plan.chunks * plan.splits, what
        # full-length slots would give the grid two blocks an SM at least
        assert plan.blocks >= 2 * sms, what


def test_split_plan_halves_splits_for_full_row_chunks():
    plan = block_attention_cuda.split_plan
    # MHA decode and a 4-query verify window: 256 keys; 8 GQA rows, 71 MQA
    # rows: 128
    assert plan(8, 1, 32, 32, 128, 16, 132).keys == 256
    assert plan(8, 4, 32, 32, 128, 16, 132).keys == 256
    assert plan(8, 1, 64, 8, 128, 16, 132).keys == 128
    assert plan(8, 1, 71, 1, 128, 16, 132).keys == 128
    # whole blocks: 256 keys of 48-key blocks round up to 288
    assert plan(8, 1, 32, 32, 64, 48, 132).keys == 288
    # one slot, one kv head: halved down to 64 keys to spread the region
    one = plan(1, 1, 1, 1, 128, 16, 132)
    assert one.keys == 64 and one.splits == 32
    # a region shorter than a split is one split
    assert plan(8, 1, 32, 32, 2, 16, 132).splits == 1
    for bad in ((0, 1, 32, 32, 128, 16, 132), (8, 1, 30, 4, 128, 16, 132),
                (8, 1, 32, 32, 128, 0, 132), (8, 1, 32, 32, 128, 16, 0)):
        with pytest.raises(ValueError, match="split_plan"):
            plan(*bad)


def _split_merge(q, ka, va, bmap, lengths, scale, keys, ks=None, vs=None):
    """The split kernel's arithmetic in numpy fp32: each split of `keys`
    keys computes its own (m, l, acc) over its visible keys, masked scores
    NEG_INF and the exponent clamped at MASK_CLAMP; the live splits are
    merged in split order (block_attn_combine_kernel). Splits past a slot's
    live keys are not read."""
    S, w, nq, hd = q.shape
    _, B, nkv, _ = ka.shape
    cap = bmap.shape[1] * B
    g = nq // nkv

    def view(arena, sc):
        x = arena[bmap].reshape(S, cap, nkv, hd).astype(np.float32)
        if sc is not None:
            x = x * sc[bmap].reshape(S, cap, nkv, 1)
        return x

    k, v = view(ka, ks), view(va, vs)
    out = np.zeros((S, w, nq, hd), np.float32)
    for s in range(S):
        n_keys = min(int(lengths[s]) + w, cap)
        for j in range(w):
            q_pos = int(lengths[s]) + j
            for qh in range(nq):
                h = qh // g
                qv = q[s, j, qh].astype(np.float32) * np.float32(scale)
                parts = []
                for lo in range(0, n_keys, keys):
                    hi = min(lo + keys, n_keys)
                    sc = k[s, lo:hi, h] @ qv
                    sc = np.where(np.arange(lo, hi) <= q_pos, sc,
                                  np.float32(NEG_INF))
                    m = sc.max()
                    p = np.exp(sc - max(m, np.float32(MASK_CLAMP)))
                    parts.append((m, p.sum(), p @ v[s, lo:hi, h]))
                mx = max(m for m, _, _ in parts)
                l_sum, acc = np.float32(0), np.zeros(hd, np.float32)
                for m, l_part, a in parts:
                    f = np.exp(m - mx)
                    l_sum += l_part * f
                    acc += a * f
                out[s, j, qh] = acc / (l_sum if l_sum > 0 else 1)
    return out


# lengths whose verify windows straddle a split's end for splits of B and
# 2B keys (B 8 and 16, w 3), with an idle row
STRADDLE = {
    "straddle_w3_mqa_b8": ((3, 3, 4, 1, 8, 6, "float32", (2,)), [7, 14, 0]),
    "straddle_w3_gqa_b16": ((3, 3, 4, 2, 16, 4, "float32", ()),
                            [15, 30, 46]),
}


@pytest.mark.parametrize("name", sorted(CASES) + sorted(STRADDLE))
def test_split_then_merge_matches_jax_kernel(name):
    """Split-KV then the combine's merge, at every keys a split a CASES
    shape can have (B, 2B and split_plan's), against the JAX kernel in
    interpret mode: the merge's math holds, splits that end mid-window and
    rows with no visible key in a split included."""
    if name in CASES:
        (S, w, nq, nkv, B, nb, dtype, idle), lens = CASES[name], None
        seed = sorted(CASES).index(name)
    else:
        (S, w, nq, nkv, B, nb, dtype, idle), lens = STRADDLE[name]
        seed = 100 + sorted(STRADDLE).index(name)
    q, ka, va, bmap, lengths, ks, vs = _case(
        seed, S=S, w=w, nq=nq, nkv=nkv, B=B, nb=nb, dtype=dtype, idle=idle,
        lengths=lens)
    scale = q.shape[-1] ** -0.5
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    want = np.asarray(jax_block_attention(
        jnp.asarray(q, jdt), jnp.asarray(ka, jdt), jnp.asarray(va, jdt),
        jnp.asarray(bmap), jnp.asarray(lengths), scale=scale, block_size=B,
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs), interpret=True),
        np.float32)
    if dtype == "bfloat16":  # the values both sides see
        q, ka, va = (torch.from_numpy(t).bfloat16().float().numpy()
                     for t in (q, ka, va))
    plan = block_attention_cuda.split_plan(S, w, nq, nkv, nb, B, 132)
    straddles = 0
    for keys in sorted({B, 2 * B, plan.keys}):
        got = _split_merge(q, ka, va, bmap, lengths, scale, keys, ks, vs)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=0,
                                   err_msg=f"{keys} keys a split")
        straddles += sum(n // keys != (n + w - 1) // keys for n in lengths)
    if name in STRADDLE:
        assert straddles >= 2
