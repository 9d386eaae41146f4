"""Binding of the Hopper flash-attention kernels.

The kernels replace the Pallas TPU kernels of
megatron_tpu/ops/flash_attention_pallas.py: csrc/flash_fwd.cu the forward
`_fwd_kernel`, csrc/flash_bwd.cu the backward `_bwd_dq_kernel` and
`_bwd_dkv_kernel`. Each source's note says what bounds it on the card and
what its design does about that.

The kernels are built by ops/cuda_build.py (nvcc for sm_90a, every
source in parallel, into `build/`). The wrappers load their library through
ctypes at first use, check their inputs, launch on PyTorch's current stream
and raise on any launch error; none falls back to another implementation.
Each wrapper counts its launches in its `launches` attribute.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from megatron_tpu_torch.ops import cuda_build
from megatron_tpu_torch.ops.cuda_build import raise_on as _raise_on

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
# kv rows a block of the bf16 dK/dV kernel owns (csrc/flash_bwd.cu DKV_ROWS)
DKV_BLOCK_ROWS = 128
# waves of blocks over the card's SMs that the dK/dV grid should reach
DKV_TARGET_WAVES = 2


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    lib = cuda_build.library(name)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    u, f = ctypes.c_uint32, ctypes.c_float
    if name == "flash_fwd":
        lib.flash_fwd.argtypes = ([p] * 6 + [i] * 7 + [ll] * 9
                                  + [f, i, i, u, u, f, i, i, i, p])
        lib.flash_fwd.restype = i
    else:
        head = [p] * 8  # q, k, v, dout, lse, delta, dlse, seg
        # ..., drop seed, threshold, scale, batch and head offsets, total
        # heads
        tail = [i] * 7 + [p, f, i, i, u, u, f, i, i, i]
        lib.flash_bwd_dq.argtypes = head + [p] + tail + [p]
        # ..., chunks, workspace, stream
        lib.flash_bwd_dkv.argtypes = head + [p, p] + tail + [i, p, p]
        lib.flash_bwd_dq.restype = i
        lib.flash_bwd_dkv.restype = i
    return lib


def _check_inputs(where: str, tensors: dict):
    """Device, dtype, layout and alignment checks shared by the wrappers:
    every tensor [b, s, n, d] on the first one's CUDA device, one dtype
    (bf16 or fp32), unit stride on d, and for bf16 16-byte aligned rows."""
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        if not t.is_cuda or t.device != first.device:
            raise ValueError(f"{where}: {name} must lie on q's CUDA device, "
                             f"got {t.device}")
        if t.dtype != first.dtype:
            raise ValueError(f"{where}: q, k, v (and dout) must share a "
                             "dtype")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{where}: {name} must be [b, s, n, d] with "
                             "unit stride on d")
    if first.dtype not in _DTYPE_CODES:
        raise ValueError(f"{where}: dtype {first.dtype} not supported "
                         "(bfloat16, float32)")
    q, k, v = tensors["q"], tensors["k"], tensors["v"]
    b, _, nq, d = q.shape
    nkv = k.shape[2]
    if d not in _HEAD_DIMS:
        raise ValueError(f"{where}: head dim {d} not in {_HEAD_DIMS}")
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != d
            or nq % nkv):
        raise ValueError(f"{where}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not form "
                         "GQA attention")
    if first.dtype == torch.bfloat16:
        # bf16 tiles are TMA copies: a tensor map takes a 16-byte aligned
        # base and strides in multiples of 16 bytes
        for name, t in tensors.items():
            if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
                raise ValueError(
                    f"{where}: bf16 {name} must start 16-byte aligned with "
                    f"strides in multiples of 8, got strides {t.stride()}")


def _segments(where: str, segment_ids, q, k) -> Optional[torch.Tensor]:
    if segment_ids is None:
        return None
    if q.shape[1] != k.shape[1] or tuple(segment_ids.shape) != (
            q.shape[0], q.shape[1]):
        raise ValueError(f"{where}: segment_ids must be [b, s] with "
                         "sq == sk")
    return segment_ids.to(device=q.device, dtype=torch.int32).contiguous()


def _dropout_args(rate: float, seed: int, nq: int, batch_offset: int,
                  head_offset: int, total_heads: Optional[int]):
    """(seed, threshold, scale, batch offset, head offset, total heads) as
    the kernels take them; scale 0 is off. The hash numbers row (batch,
    q-head) as (batch + batch_offset) * total_heads + head_offset + q-head
    (total_heads None: nq)."""
    total = nq if total_heads is None else int(total_heads)
    if batch_offset < 0 or head_offset < 0 or total < head_offset + nq:
        raise ValueError(f"flash kernels: dropout index (batch offset "
                         f"{batch_offset}, head offset {head_offset}, total "
                         f"heads {total}) does not hold {nq} heads")
    if not rate:
        return 0, 0, 0.0, 0, 0, nq
    return (int(seed) & 0xFFFFFFFF, int(rate * float(2 ** 31)),
            1.0 / (1.0 - rate), int(batch_offset), int(head_offset), total)


def _window(sliding_window) -> int:
    if sliding_window is not None and sliding_window <= 0:
        raise ValueError("flash kernels: sliding_window must be > 0")
    return int(sliding_window or 0)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def dkv_head_chunks(b: int, sk: int, nkv: int, group: int, sms: int) -> int:
    """How many chunks the bf16 dK/dV kernel splits each kv head's group of
    q-heads into: one block a (batch, kv head, 128 kv rows) leaves an MQA
    grid short of the card (Falcon-7B, 71/1 heads at s 2048: 16 blocks for
    132 SMs), so the chunks multiply the grid up to DKV_TARGET_WAVES waves
    of `sms` blocks, at most one chunk a q-head. One chunk needs no
    workspace and no summing pass."""
    blocks = b * nkv * -(-sk // DKV_BLOCK_ROWS)
    return min(group, -(-DKV_TARGET_WAVES * sms // blocks)) if blocks else 1


def head_chunk_bounds(group: int, chunks: int) -> list:
    """The q-heads [begin, end) within a group that each chunk's blocks sum,
    as the kernel computes them (chunk c: c * group // chunks onward)."""
    return [(c * group // chunks, (c + 1) * group // chunks)
            for c in range(chunks)]


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, scale: float,
                   sliding_window: Optional[int] = None,
                   segment_ids: Optional[torch.Tensor] = None,
                   dropout_rate: float = 0.0, dropout_seed: int = 0,
                   batch_offset: int = 0, head_offset: int = 0,
                   total_heads: Optional[int] = None):
    """q [b, sq, nq, d], k/v [b, sk, nkv, d] on one CUDA device, bf16 or
    fp32, d in (64, 128), unit stride on d; `segment_ids` [b, s] (sq == sk)
    or None. `batch_offset`, `head_offset` and `total_heads` place the
    call's rows in a larger call's dropout mask (`_dropout_args`). Returns
    (out [b, sq, nq, d] in q's dtype, lse [b, nq, sq] fp32)."""
    where = "flash_fwd_cuda"
    _check_inputs(where, {"q": q, "k": k, "v": v})
    seg = _segments(where, segment_ids, q, k)
    window = _window(sliding_window)
    b, sq, nq, d = q.shape
    drop = _dropout_args(dropout_rate, dropout_seed, nq, batch_offset,
                         head_offset, total_heads)
    _, sk, nkv, _ = k.shape
    out = torch.empty(b, sq, nq, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, nq, sq, dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    lib = _library("flash_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _ptr(seg), _DTYPE_CODES[q.dtype], d, b, sq, sk,
            nq, nkv, q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            float(scale), int(causal), window, *drop, stream)
    _raise_on(rc, where)
    flash_fwd_cuda.launches += 1
    return out, lse


flash_fwd_cuda.launches = 0


def _bwd_args(where, q, k, v, dout, lse, delta, dlse, segment_ids,
              sliding_window, dropout_rate, dropout_seed, batch_offset,
              head_offset, total_heads):
    _check_inputs(where, {"q": q, "k": k, "v": v, "dout": dout})
    if dout.shape != q.shape:
        raise ValueError(f"{where}: dout must have q's shape")
    b, sq, nq, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta), ("dlse", dlse)):
        if t is None:
            continue
        if (t.dtype != torch.float32 or t.device != q.device
                or tuple(t.shape) != (b, nq, sq) or not t.is_contiguous()):
            raise ValueError(f"{where}: {name} must be a contiguous fp32 "
                             f"[b, nq, sq] tensor on q's device")
    seg = _segments(where, segment_ids, q, k)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *dout.stride()[:3])
    return seg, strides, _window(sliding_window), _dropout_args(
        dropout_rate, dropout_seed, nq, batch_offset, head_offset,
        total_heads)


def flash_bwd_dq_cuda(q, k, v, dout, lse, delta, *, causal: bool,
                      scale: float, sliding_window: Optional[int] = None,
                      segment_ids=None, dropout_rate: float = 0.0,
                      dropout_seed: int = 0, dlse=None,
                      batch_offset: int = 0, head_offset: int = 0,
                      total_heads: Optional[int] = None) -> torch.Tensor:
    """dQ of flash attention. q, k, v and the dropout index as
    `flash_fwd_cuda` takes them, dout [b, sq, nq, d] in their dtype, lse
    and delta (and `dlse`, or None) contiguous fp32 [b, nq, sq]. Returns dq
    [b, sq, nq, d] in q's dtype."""
    where = "flash_bwd_dq_cuda"
    seg, strides, window, drop = _bwd_args(
        where, q, k, v, dout, lse, delta, dlse, segment_ids, sliding_window,
        dropout_rate, dropout_seed, batch_offset, head_offset, total_heads)
    b, sq, nq, d = q.shape
    dq = torch.empty(b, sq, nq, d, dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq
    lib = _library("flash_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), _ptr(dlse), _ptr(seg),
            dq.data_ptr(), _DTYPE_CODES[q.dtype], d, b, sq, k.shape[1], nq,
            k.shape[2], strides, float(scale), int(causal), window, *drop,
            stream)
    _raise_on(rc, where)
    flash_bwd_dq_cuda.launches += 1
    return dq


flash_bwd_dq_cuda.launches = 0


def flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, *, causal: bool,
                       scale: float, sliding_window: Optional[int] = None,
                       segment_ids=None, dropout_rate: float = 0.0,
                       dropout_seed: int = 0, dlse=None,
                       batch_offset: int = 0, head_offset: int = 0,
                       total_heads: Optional[int] = None):
    """dK and dV of flash attention, summed over each kv head's GQA group
    without atomics: inside the kernel, or for bf16, where the group's
    q-heads are split into chunks (`dkv_head_chunks`), over fp32 partials in
    a workspace that a second kernel sums in a fixed order. Arguments as
    `flash_bwd_dq_cuda`. Returns (dk, dv), contiguous [b, sk, nkv, d] in
    k's dtype."""
    where = "flash_bwd_dkv_cuda"
    seg, strides, window, drop = _bwd_args(
        where, q, k, v, dout, lse, delta, dlse, segment_ids, sliding_window,
        dropout_rate, dropout_seed, batch_offset, head_offset, total_heads)
    b, sq, nq, d = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    dk = torch.empty(b, sk, nkv, d, dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    if dk.numel() == 0:
        return dk, dv
    chunks, workspace = 1, None
    if q.dtype == torch.bfloat16:
        chunks = dkv_head_chunks(b, sk, nkv, nq // nkv,
                                 cuda_build.sm_count(q.device.index))
    if chunks > 1:
        workspace = torch.empty(2, chunks, b, sk, nkv, d,
                                dtype=torch.float32, device=q.device)
    lib = _library("flash_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), _ptr(dlse), _ptr(seg),
            dk.data_ptr(), dv.data_ptr(), _DTYPE_CODES[q.dtype], d, b, sq,
            sk, nq, nkv, strides, float(scale), int(causal), window, *drop,
            chunks, _ptr(workspace), stream)
    _raise_on(rc, where)
    flash_bwd_dkv_cuda.launches += 1
    return dk, dv


flash_bwd_dkv_cuda.launches = 0

KERNELS = (flash_fwd_cuda, flash_bwd_dq_cuda, flash_bwd_dkv_cuda)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}
