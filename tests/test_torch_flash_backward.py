"""The port's flash attention with segment ids, dropout and its backward, on
the CPU (the plain versions), against the JAX package's Pallas kernels in
interpret mode, on the same numpy inputs in fp32.

Tolerance 2e-5 on out and 2e-5 on grads (inputs of magnitude ~1): the same
fp32 formulas summed in another order. The dropout keep bits must match
exactly: the port re-implements the TPU kernel's counter hash, and a single
differing bit would move an output by a whole probability weight.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu.ops.flash_attention_pallas import (
    STAT_LANES, _dropout_keep, pallas_flash_attention,
    pallas_flash_attention_with_lse)
from megatron_tpu_torch.ops import flash_attention as fa
from megatron_tpu_torch.ops import flash_attention_cuda as fc

torch.set_num_threads(2)
TOL = 2e-5
SEED = 12345
RATE = 0.2
B, S, D = 2, 256, 64
BLOCK = 128


def _inputs(nq, nkv, seed=0):
    rs = np.random.RandomState(seed)
    return tuple(rs.standard_normal(shape).astype(np.float32) for shape in (
        (B, S, nq, D), (B, S, nkv, D), (B, S, nkv, D), (B, S, nq, D)))


def _segments():
    seg = np.zeros((B, S), np.int32)
    seg[:, 100:] = 1
    seg[1, 200:] = 2
    return seg


def _jax_fn(mode):
    """The reference call for a mask mode: causal alone, with a sliding
    window, with segment ids, with dropout, or with both of those."""
    seg = (jnp.asarray(_segments(), jnp.float32) if "segments" in mode
           else None)
    window = 48 if mode == "window" else None
    rate = RATE if "dropout" in mode else 0.0
    seed = (jnp.full((1, STAT_LANES), float(SEED)) if "dropout" in mode
            else None)
    return lambda q, k, v: pallas_flash_attention(
        q, k, v, True, None, BLOCK, BLOCK, True, seg, seg, window, rate, seed)


def _port_kw(mode):
    return dict(causal=True, scale=D ** -0.5,
                sliding_window=48 if mode == "window" else None,
                segment_ids=(torch.from_numpy(_segments())
                             if "segments" in mode else None),
                dropout_rate=RATE if "dropout" in mode else 0.0,
                dropout_seed=SEED)


MODES = ["causal", "window", "segments", "dropout"]
HEADS = [(4, 4), (4, 2), (4, 1)]


@pytest.mark.parametrize("mode", ["segments", "dropout"])
def test_plain_forward_matches_pallas_interpret(mode):
    q, k, v, _ = _inputs(4, 2, seed=1)
    want = _jax_fn(mode)(*map(jnp.asarray, (q, k, v)))
    got, lse = fa.blockwise_attention(
        *map(torch.from_numpy, (q, k, v)), block_kv=96, **_port_kw(mode))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    assert torch.isfinite(lse).all()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("nq,nkv", HEADS)
def test_plain_backward_matches_jax_vjp(nq, nkv, mode):
    """dq/dk/dv of the Function on CPU tensors (plain forward + plain
    backward) against jax.vjp of the Pallas kernel."""
    q, k, v, do = _inputs(nq, nkv, seed=nq + nkv)
    want, vjp = jax.vjp(_jax_fn(mode), *map(jnp.asarray, (q, k, v)))
    wants = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, **_port_kw(mode))
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    for t, w in zip((tq, tk, tv), wants):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


def test_plain_backward_with_segments_and_dropout_matches_jax_vjp():
    """Segment ids and dropout together, at 4/1 heads: the path of the
    kernels' EXTRA instantiations with the MQA group sum, against jax.vjp
    of the Pallas kernel."""
    q, k, v, do = _inputs(4, 1, seed=13)
    mode = "segments_dropout"
    want, vjp = jax.vjp(_jax_fn(mode), *map(jnp.asarray, (q, k, v)))
    wants = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, **_port_kw(mode))
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    for t, w in zip((tq, tk, tv), wants):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


H100_SMS = 132
# (b, sk, nq, nkv): Llama-2-7B's training shape, GQA 64/8, Falcon-7B's MQA
# at its 2048 positions and at the engine's 1,000, and a tiny grid
CHUNK_SHAPES = [(1, 4096, 32, 32), (1, 4096, 64, 8), (1, 2048, 71, 1),
                (1, 1000, 71, 1), (2, 256, 4, 1)]


@pytest.mark.parametrize("b,sk,nq,nkv", CHUNK_SHAPES)
def test_dkv_head_chunks_cover_every_head_once(b, sk, nq, nkv):
    """The chunks the chooser takes split each group's q-heads into
    non-empty, disjoint ranges that together hold every head once."""
    group = nq // nkv
    chunks = fc.dkv_head_chunks(b, sk, nkv, group, H100_SMS)
    assert 1 <= chunks <= group
    bounds = fc.head_chunk_bounds(group, chunks)
    assert all(hi > lo for lo, hi in bounds)
    assert [h for lo, hi in bounds for h in range(lo, hi)] == list(
        range(group))


def test_dkv_head_chunks_keep_llama_in_one_chunk():
    """Llama-2-7B's training shape (b 1, s 4096, 32/32 heads) fills the card
    with 1,024 blocks: no split, no workspace, no summing pass."""
    assert fc.dkv_head_chunks(1, 4096, 32, 1, H100_SMS) == 1


def test_dkv_head_chunks_fill_the_card_for_falcon_mqa():
    """Falcon-7B (71/1 heads) at s 2048 has 16 kv tiles of 128 rows: the
    chooser takes the fewest chunks that reach the target waves."""
    blocks = 2048 // fc.DKV_BLOCK_ROWS
    target = fc.DKV_TARGET_WAVES * H100_SMS
    chunks = fc.dkv_head_chunks(1, 2048, 1, 71, H100_SMS)
    assert chunks * blocks >= target > (chunks - 1) * blocks
    assert chunks <= 71


def test_lse_cotangent_matches_pallas_with_lse():
    """An lse cotangent (ring attention's merge weights) enters the
    backward as dlse, as in pallas_flash_attention_with_lse."""
    q, k, v, do = _inputs(4, 2, seed=5)
    dlse = np.random.RandomState(6).standard_normal((B, S, 4)).astype(
        np.float32)
    fn = lambda q_, k_, v_: pallas_flash_attention_with_lse(  # noqa: E731
        q_, k_, v_, True, None, BLOCK, BLOCK, True)
    (_, want_lse), vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    wants = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out, lse = fa.flash_attention_with_lse(tq, tk, tv)
    np.testing.assert_allclose(lse.detach().numpy(),
                               np.asarray(want_lse).transpose(0, 2, 1),
                               rtol=TOL, atol=TOL)
    torch.autograd.backward(
        [out, lse], [torch.from_numpy(do),
                     torch.from_numpy(dlse).transpose(1, 2)])
    for t, w in zip((tq, tk, tv), wants):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keep_is_bit_exact(rate):
    """The keep mask of whole (q block, kv block) tiles of several heads,
    against the JAX function, bit for bit."""
    for bh, qi, ki in [(0, 0, 0), (5, 3, 1), (137, 7, 30), (4095, 31, 2)]:
        want = np.asarray(_dropout_keep(
            jnp.int32(SEED), jnp.int32(bh), jnp.int32(qi), jnp.int32(ki),
            BLOCK, BLOCK, rate))
        q_pos = torch.arange(qi * BLOCK, (qi + 1) * BLOCK)[:, None]
        kv_pos = torch.arange(ki * BLOCK, (ki + 1) * BLOCK)[None]
        got = fa._dropout_keep(SEED, bh, q_pos, kv_pos, rate).numpy()
        np.testing.assert_array_equal(got, want)
        assert abs(got.mean() - (1 - rate)) < 0.05


def test_dropout_seed_comes_from_the_generator():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(2, 2, seed=7))
    kw = dict(causal=True, dropout_rate=0.3)
    a = fa.flash_attention(q, k, v, generator=torch.Generator().manual_seed(
        3), **kw)
    b = fa.flash_attention(q, k, v, generator=torch.Generator().manual_seed(
        3), **kw)
    c = fa.flash_attention(q, k, v, generator=torch.Generator().manual_seed(
        4), **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="generator"):
        fa.flash_attention(q, k, v, **kw)


@pytest.mark.parametrize("mode", MODES)
def test_plain_backward_equals_autograd_through_plain_forward(mode):
    """The plain backward's formulas against torch.autograd through the
    plain forward, with an lse cotangent too."""
    q, k, v, do = _inputs(4, 2, seed=9)
    dl = torch.from_numpy(np.random.RandomState(10).standard_normal(
        (B, 4, S)).astype(np.float32))
    kw = _port_kw(mode)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out, lse = fa.blockwise_attention(tq, tk, tv, block_kv=64, **kw)
    # rows with no visible key carry the constant NEG_INF lse; autograd's
    # path through it is zero, as in the kernel formulas
    torch.autograd.backward([out, lse], [torch.from_numpy(do), dl])
    delta = fa.attention_delta(out.detach(), torch.from_numpy(do))
    dq, dk, dv = fa.blockwise_attention_bwd(
        *map(torch.from_numpy, (q, k, v, do)), lse.detach(), delta,
        dlse=dl, **kw)
    for t, g in zip((tq, tk, tv), (dq, dk, dv)):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), rtol=TOL,
                                   atol=TOL)
