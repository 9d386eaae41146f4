"""The port's context-parallel attention (parallel/ring_attention.py,
parallel/ulysses.py) against the JAX package's `ring_attention` and
`ulysses_attention` on the 8-device virtual CPU mesh
(tests/conftest.py `make_test_mesh`), from the same numpy q, k and v in
fp32. The port's cp ranks are gloo processes (tests/mesh_pool.py); their
rows of the output and their parts of dq, dk, dv (of sum(tanh(out))) are
joined along the sequence and held to JAX's.

Limits, and the readings they were set from (this CPU, every case below):
- outputs 2e-5 and grads 5e-4 relative to the largest magnitude, with an
  absolute floor of 1e-5: the reference's own ring-vs-full limits
  (tests/test_ring_attention.py:57,79; read: at most 3.5e-7 and 3.6e-7);
- the zigzag permutation and the pair counts exactly;
- the attention layer's cp fallback (segment ids, attention dropout)
  against the unsharded call of the port: outputs 1e-5 and grads 1e-4
  relative (read: the outputs bit for bit, the grads at most 2.7e-7).
  The dropout masks are the flash kernels' hash of the same seed, so they
  agree bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_ranks
from conftest import make_test_mesh
from megatron_tpu.parallel import ring_attention as jring
from megatron_tpu.parallel.ulysses import ulysses_attention as j_ulysses
from megatron_tpu_torch import config as tc
from megatron_tpu_torch.parallel import ring_attention as tring
from mesh_pool import RankPool

torch.set_num_threads(2)
OUT_TOL, GRAD_TOL, ABS_FLOOR = 2e-5, 5e-4, 1e-5
D = 16


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


def qkv(b, s, nq, nkv, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, s, nq, D).astype(np.float32),
            rs.randn(b, s, nkv, D).astype(np.float32),
            rs.randn(b, s, nkv, D).astype(np.float32))


def jax_cp(fn, q, k, v, cp):
    """JAX's cp attention and the grads of sum(tanh(out)), on a cp mesh."""
    mesh = make_test_mesh(jax.devices(), dp=1, cp=cp, tp=1)

    def loss(q, k, v):
        return jnp.sum(jnp.tanh(fn(q, k, v, mesh)))
    with jax.set_mesh(mesh):
        out = jax.jit(lambda q, k, v: fn(q, k, v, mesh))(q, k, v)
        grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def port_cp(pool, algo, q, k, v, cp, causal, layout="auto", impl="flash"):
    ranks = pool.run(cp, mesh_ranks.cp_attention, algo, q, k, v, cp,
                     causal, layout, impl)
    if "error" in ranks[0]:
        return ranks[0]["error"]
    out = np.concatenate([r["out"] for r in ranks], axis=1)
    grads = [np.concatenate([r["grads"][i] for r in ranks], axis=1)
             for i in range(3)]
    return out, grads


def close(got, want, tol):
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= max(tol * scale, ABS_FLOOR), (err, scale)


def check(got, want):
    close(got[0], want[0], OUT_TOL)
    for g, w in zip(got[1], want[1]):
        close(g, w, GRAD_TOL)


@pytest.mark.parametrize("S,cp", [(16, 2), (32, 4), (48, 4), (64, 8)])
def test_zigzag_permutation_and_pair_counts_match_jax(S, cp):
    for a, b in zip(tring.zigzag_permutation(S, cp),
                    jring.zigzag_permutation(S, cp)):
        np.testing.assert_array_equal(a, b)
    assert tring.zigzag_pair_counts(cp) == jring.zigzag_pair_counts(cp)
    assert len(set(tring.zigzag_pair_counts(cp))) == 1


# (cp, layout, causal, nq, nkv): MHA, GQA and MQA; both layouts; causal
# and not
RING_CASES = [
    (2, "contiguous", True, 4, 4),
    (2, "zigzag", True, 4, 2),
    (4, "zigzag", True, 4, 1),
    (4, "contiguous", True, 4, 2),
    (2, "contiguous", False, 4, 2),
    (4, "pre_zigzag", True, 4, 2),
]


@pytest.mark.parametrize("cp,layout,causal,nq,nkv", RING_CASES)
def test_ring_matches_jax(pool, cp, layout, causal, nq, nkv):
    S = 8 * cp
    q, k, v = qkv(2, S, nq, nkv)
    if layout == "pre_zigzag":
        # both sides take the batch already permuted
        perm, _ = tring.zigzag_permutation(S, cp)
        q, k, v = q[:, perm], k[:, perm], v[:, perm]
    want = jax_cp(lambda q, k, v, m: jring.ring_attention(
        q, k, v, m, causal=causal, impl="xla",
        layout=layout if layout == "pre_zigzag" else "auto"), q, k, v, cp)
    check(port_cp(pool, "ring", q, k, v, cp, causal, layout), want)


def test_plain_ring_matches_jax(pool):
    """The ring's plain inner block (`_local_block_attention`)."""
    q, k, v = qkv(1, 16, 4, 2, seed=3)
    want = jax_cp(lambda q, k, v, m: jring.ring_attention(
        q, k, v, m, causal=True, impl="xla"), q, k, v, 2)
    check(port_cp(pool, "ring", q, k, v, 2, True, impl="plain"), want)


def test_ring_matches_jax_flash_inner(pool):
    """One shape against the reference's Pallas inner block, in interpret
    mode, zigzag layout."""
    q, k, v = qkv(1, 32, 2, 1, seed=4)
    want = jax_cp(lambda q, k, v, m: jring.ring_attention(
        q, k, v, m, causal=True, impl="flash", layout="zigzag"),
        q, k, v, 2)
    check(port_cp(pool, "ring", q, k, v, 2, True, "zigzag"), want)


@pytest.mark.parametrize("cp,causal,nq,nkv", [(2, True, 4, 2),
                                              (4, True, 4, 4),
                                              (2, False, 4, 4)])
def test_ulysses_matches_jax(pool, cp, causal, nq, nkv):
    q, k, v = qkv(2, 8 * cp, nq, nkv, seed=1)
    want = jax_cp(lambda q, k, v, m: j_ulysses(q, k, v, m, causal=causal),
                  q, k, v, cp)
    check(port_cp(pool, "ulysses", q, k, v, cp, causal), want)


def test_indivisible_heads_raise(pool):
    q, k, v = qkv(1, 16, 4, 2)
    err = port_cp(pool, "ulysses", q, k, v, 4, True)
    assert isinstance(err, str) and "divisible by cp=4" in err
    kw = dict(num_layers=2, hidden_size=96, num_attention_heads=6,
              num_kv_heads=2, vocab_size=256, seq_length=16,
              attention_impl="ulysses")
    with pytest.raises(ValueError, match="divisible by"):
        tc.MegatronConfig(model=tc.llama2_config("tiny", **kw),
                          parallel=tc.ParallelConfig(context_parallel=4)
                          ).validate(n_devices=4)
    with pytest.raises(ValueError, match="replicated over tp"):
        tc.MegatronConfig(
            model=tc.llama2_config("tiny", **dict(
                kw, hidden_size=64, num_attention_heads=8, num_kv_heads=2)),
            parallel=tc.ParallelConfig(context_parallel=2,
                                       tensor_parallel=4)
        ).validate(n_devices=8)


@pytest.mark.parametrize("impl,dropout", [("ring", 0.0), ("ring", 0.3),
                                          ("ulysses", 0.3)])
def test_cp_fallback_equals_unsharded_call(pool, impl, dropout):
    """Segment ids (and attention dropout) send cp attention off the ring:
    the sequence is gathered over cp, the flash kernel runs on it, and
    each rank keeps its rows, which must be the unsharded call's."""
    kw = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
              vocab_size=256, seq_length=16, max_position_embeddings=16,
              compute_dtype="float32", attention_impl=impl,
              attention_dropout=dropout)
    cfg = tc.MegatronConfig(model=tc.gpt_config(**kw))
    from megatron_tpu_torch.models.attention import attention_init
    rs = np.random.RandomState(5)
    params = {k: (rs.randn(*shape) * 0.1).astype(np.float32)
              for k, (shape, _) in attention_init(
                  cfg.validate().model).items()}
    x = rs.randn(2, 16, 64).astype(np.float32)
    seg = np.repeat(np.array([[0] * 5 + [1] * 7 + [2] * 4]), 2, 0)
    seed = 7 if dropout else None
    cfg = cfg.validate()
    want = pool.run(1, mesh_ranks.cp_attention_layer, cfg, params, x, seg,
                    1, seed)[0]
    ranks = pool.run(2, mesh_ranks.cp_attention_layer, cfg, params, x, seg,
                     2, seed)
    out = np.concatenate([r["out"] for r in ranks], axis=1)
    dx = np.concatenate([r["dx"] for r in ranks], axis=1)
    close(out, want["out"], 1e-5)
    close(dx, want["dx"], 1e-4)
    for k, w in want["dw"].items():
        close(sum(r["dw"][k] for r in ranks), w, 1e-4)
