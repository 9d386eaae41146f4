"""The port's flash attention on the CPU (its plain version) against the
JAX package's Pallas kernel in interpret mode and its XLA blockwise path,
on the same numpy inputs, in fp32. Tolerance 2e-5: the same fp32 algorithm
summed in a different order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu.ops.flash_attention import _blockwise_attention
from megatron_tpu.ops.flash_attention_pallas import (
    pallas_flash_attention, pallas_flash_attention_with_lse)
from megatron_tpu_torch.ops import flash_attention_cuda
from megatron_tpu_torch.ops.flash_attention import (blockwise_attention,
                                                    flash_attention,
                                                    flash_attention_with_lse)

torch.set_num_threads(2)
TOL = 2e-5


def _inputs(b, s, nq, nkv, d, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.standard_normal((b, s, nq, d)).astype(np.float32),
            rs.standard_normal((b, s, nkv, d)).astype(np.float32),
            rs.standard_normal((b, s, nkv, d)).astype(np.float32))


def _port(q, k, v, **kw):
    out, lse = flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw)
    return out.numpy(), lse.numpy()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("nq,nkv", [(4, 4), (4, 2), (4, 1)])
def test_matches_pallas_interpret_and_blockwise(nq, nkv, causal):
    q, k, v = _inputs(2, 256, nq, nkv, 64)
    got, got_lse = _port(q, k, v, causal=causal)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want, want_lse = pallas_flash_attention_with_lse(jq, jk, jv, causal,
                                                     None, 128, 128, True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
    # the reference returns lse [b, sq, nq]; the port [b, nq, sq]
    np.testing.assert_allclose(got_lse, np.asarray(want_lse).transpose(0, 2, 1),
                               rtol=TOL, atol=TOL)
    blockwise = _blockwise_attention(jq, jk, jv, causal=causal, scale=None,
                                     block_kv=512)
    np.testing.assert_allclose(got, np.asarray(blockwise), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("window", [32, 100])
def test_sliding_window_matches_pallas_interpret(window):
    q, k, v = _inputs(2, 256, 4, 2, 64, seed=1)
    got, _ = _port(q, k, v, causal=True, sliding_window=window)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = pallas_flash_attention(jq, jk, jv, True, None, 128, 128, True,
                                  None, None, window)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
    blockwise = _blockwise_attention(jq, jk, jv, causal=True, scale=None,
                                     block_kv=512, sliding_window=window)
    np.testing.assert_allclose(got, np.asarray(blockwise), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("block_kv", [512, 64])
def test_ragged_length_matches_blockwise(block_kv):
    """s = 200 is not a multiple of the kernel's tiles: the reference sends
    it to XLA; the port's plain version handles the short last block."""
    q, k, v = _inputs(2, 200, 4, 2, 64, seed=2)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = _blockwise_attention(jq, jk, jv, causal=True, scale=None,
                                block_kv=block_kv)
    got, _ = blockwise_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=True,
                                 scale=None, block_kv=block_kv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


def test_empty_rows_give_zero_output_and_neg_inf_lse():
    """A window that leaves a row no key: the kernel's rule (out 0, lse
    NEG_INF) holds in the plain version too."""
    q, k, v = _inputs(1, 8, 2, 2, 64, seed=3)
    out, lse = flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k[:, :4]),
        torch.from_numpy(v[:, :4]), causal=True, sliding_window=2)
    assert torch.all(out[:, 5:] == 0)
    assert torch.all(lse[:, :, 5:] == -1e30)
    assert torch.all(torch.isfinite(out))


def test_cpu_tensors_take_the_plain_version_not_the_kernel():
    """Forward and backward, with segment ids and dropout too: CPU tensors
    never reach a kernel, so no launch counter moves."""
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _inputs(1, 16, 2, 1, 64))
    before = flash_attention_cuda.launch_counts()
    out = flash_attention(q, k, v, causal=True)
    assert out.shape == q.shape and out.dtype == q.dtype
    seg = torch.zeros(1, 16, dtype=torch.int32)
    seg[:, 9:] = 1
    out2 = flash_attention(q, k, v, segment_ids=seg, dropout_rate=0.1,
                           generator=torch.Generator().manual_seed(0))
    (out.sum() + out2.sum()).backward()
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))
    assert flash_attention_cuda.launch_counts() == before


def test_kernel_wrapper_rejects_cpu_tensors():
    """The kernel's wrapper never computes on the CPU itself."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 16, 2, 1, 64))
    with pytest.raises(ValueError):
        flash_attention_cuda.flash_fwd_cuda(q, k, v, causal=True, scale=0.1)


def _pad_rows(a, s):
    return np.pad(a, ((0, 0), (0, s - a.shape[1]), (0, 0), (0, 0)))


def _segment_ids(b, s):
    """Three documents a row, with boundaries inside 128-row tiles."""
    seg = np.zeros((b, s), np.int32)
    seg[:, 77:] = 1
    seg[:, 200:] = 2
    return seg


@pytest.mark.parametrize("case", ["s129_mqa_window100",
                                  "segments_inside_tile"])
def test_kernel_tile_edges_match_pallas_interpret(case):
    """Where the Hopper kernel's 128-row tiles break: s 129 (one row past a
    tile) with MQA and a window of 100, and segment boundaries inside a
    tile. The Pallas kernel tiles s by multiples of 128, so at s 129 it runs
    on k, v and q zero-padded to 256: under causal masking the first 129
    rows never see a padded key, and those rows are compared."""
    if case == "s129_mqa_window100":
        q, k, v = _inputs(2, 129, 4, 1, 64, seed=4)
        got, _ = _port(q, k, v, causal=True, sliding_window=100)
        padded = [jnp.asarray(_pad_rows(a, 256)) for a in (q, k, v)]
        want = pallas_flash_attention(*padded, True, None, 128, 128, True,
                                      None, None, 100)[:, :129]
        blockwise = _blockwise_attention(*map(jnp.asarray, (q, k, v)),
                                         causal=True, scale=None,
                                         block_kv=512, sliding_window=100)
        np.testing.assert_allclose(got, np.asarray(blockwise), rtol=TOL,
                                   atol=TOL)
    else:
        q, k, v = _inputs(2, 256, 4, 2, 64, seed=5)
        seg = _segment_ids(2, 256)
        got, _ = _port(q, k, v, causal=True,
                       segment_ids=torch.from_numpy(seg))
        fseg = jnp.asarray(seg, jnp.float32)
        want = pallas_flash_attention(*map(jnp.asarray, (q, k, v)), True,
                                      None, 128, 128, True, fseg, fseg)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


def test_every_included_header_is_a_build_input():
    """A library is named by the hash of its source and of
    cuda_build.HEADERS: a header a source includes but HEADERS lacks would
    leave a stale library in use after the header changed."""
    import re
    from megatron_tpu_torch.ops import cuda_build
    listed = {h.name for h in cuda_build.HEADERS}
    included = set()
    for src in sorted(cuda_build.CSRC.glob("*.cu")):
        included |= set(re.findall(r'#include\s+"([^"]+\.cuh)"',
                                   src.read_text()))
    assert included, "no source includes a local header"
    assert included <= listed, f"not in HEADERS: {included - listed}"
    assert all(h.exists() for h in cuda_build.HEADERS)
