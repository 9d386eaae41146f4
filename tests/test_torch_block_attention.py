"""The port's block-native decode attention against the JAX package's Pallas
kernel (`block_native_attention(..., interpret=True)`) on the same numpy
inputs, and the block pool that feeds it.

On the CPU the port's `block_native_attention` is its plain version (the
Hopper kernel runs on the card, held against the plain version by
chip_smoke.py). Tolerances: fp32 1e-5 (the same fp32 softmax, summed in
another order), bf16 1e-2 (one bf16 rounding of the output), int8 with
scales 1e-5 (dequantized in fp32 on both sides, fp32 queries)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu.ops.block_attention_pallas import \
    block_native_attention as jax_block_attention
from megatron_tpu_torch import config as tconfig
from megatron_tpu_torch.models.attention import KVCache
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
    with pytest.raises(NotImplementedError, match="prefix cache"):
        pool.retain_row(slot, 4, [1, 2, 3, 4])
    with pytest.raises(NotImplementedError, match="prefix cache"):
        pool.on_reclaim = lambda key: None


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
