"""Binding of the Hopper fused-norm kernels.

csrc/fused_norms.cu replaces the four Pallas TPU kernels of
megatron_tpu/ops/fused_norms.py (`_rms_fwd_kernel`, `_rms_bwd_kernel`,
`_ln_fwd_kernel`, `_ln_bwd_kernel`); its note says what bounds them on the
card and what the design does about that. It is built with the other kernels
by ops/cuda_build.py. Each wrapper takes rows x [rows, h] (and dy), checks
its inputs, launches on PyTorch's current stream, raises on any launch
error (a wide forward row too wide for a block's shared memory among
them), and counts its launches in its `launches` attribute. The backward
wrappers return dx and fp32 [1, h] sums of dscale (and dbias) over every
row, summed inside their launches in a fixed order. `fwd_plan` and
`bwd_plan` lay the two directions out.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from megatron_tpu_torch.ops import cuda_build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# warps of a block (csrc/fused_norms.cu THREADS / 32); the wide forward's
# row takes 1, 2, 4 or 8 of them
WARPS = 8
# The rows kernels (both directions): chunks a thread may hold (their
# instantiations) and the most values of x a thread may hold, so that a
# thread stays within 128 registers and an SM holds 16 warps: two blocks of
# 8, or one of 16 when a row takes 16 warps. Wider rows take the wide
# kernels.
CHUNKS = (2, 4, 8)
MAX_VALUES = 16
WARPS_PER_SM = 16
# rows of the vector path's ring, a slot (csrc/fused_norms.cu RING)
RING = 2


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_build.library("fused_norms")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.fused_norm_fwd.argtypes = [p] * 4 + [i] * 5 + [ll] + [i] * 5 + [f, p]
    lib.fused_norm_fwd.restype = i
    lib.fused_norm_bwd.argtypes = [p] * 6 + [i] * 4 + [ll] + [i] * 5 + [f, p]
    lib.fused_norm_bwd.restype = i
    return lib


def warps_per_row(h: int, itemsize: int) -> int:
    """The wide forward's warps owning one row: the fewest (1, 2, 4, 8)
    that leave each thread at most two 16-byte chunks, so a block holds
    8 // wpr rows."""
    chunks = -(-h * itemsize // 16)
    wpr = 1
    while wpr < WARPS and 32 * wpr * 2 < chunks:
        wpr *= 2
    return wpr


@dataclasses.dataclass(frozen=True)
class NormPlan:
    """Launch plan of one direction (csrc/fused_norms.cu). A slot of `wpr`
    warps owns a row; chunk c of it (`values` elements: 16 bytes on the
    vector path, one element on the scalar one) belongs to thread
    c % (32 * wpr) of the slot, at most `chunks` a thread. The rows
    kernels run `blocks` persistent blocks of `threads`, `resident` to an
    SM, that stride over the rows; they hold a thread's chunks in registers
    and, on the vector path, take each slot's next rows through a ring of
    RING rows. `wide` rows (over 8 chunks or MAX_VALUES a thread) take the
    wide kernels: the backward's walks them in device memory, 16 warps a
    row, one block an SM; the forward's keeps each row in shared memory, a
    block of 8 warps for every 8 // wpr rows (`resident` 0: not
    persistent). `smem` is a block's dynamic shared bytes; `in_flight` the
    bytes of rows an SM has in flight, the ring full."""
    h: int
    vec: bool
    wide: bool
    values: int
    wpr: int
    chunks: int
    threads: int
    rows_per_block: int
    resident: int
    blocks: int
    smem: int
    in_flight: int

    def columns(self, t: int) -> list:
        """The columns thread t of a slot owns, in chunk order."""
        tpr = 32 * self.wpr
        return [c * self.values + i for j in range(self.chunks)
                for c in [t + j * tpr] if c * self.values < self.h
                for i in range(self.values)]


def _layout(where: str, rows: int, h: int, itemsize: int, sms: int,
            aligned: bool):
    """(vec, values, wpr, chunks, wide) of the rows kernels: vector path
    where the row's bytes are a multiple of 16 and `aligned`; the fewest
    warps a row (1-16) that leave a thread at most 2 chunks, else 16 warps
    and 4 or 8 chunks, at most MAX_VALUES values a thread; past that wide."""
    if rows < 1 or h < 1 or itemsize not in (2, 4) or sms < 1:
        raise ValueError(f"{where}: no plan for rows {rows}, h {h}, "
                         f"itemsize {itemsize}, {sms} SMs")
    vec = aligned and (h * itemsize) % 16 == 0
    values = 16 // itemsize if vec else 1
    nch = h // values

    def need(wpr):
        return -(-nch // (32 * wpr))
    wpr = next((w for w in (1, 2, 4, 8, 16) if need(w) <= 2), 16)
    chunks = next((c for c in CHUNKS if need(wpr) <= c
                   and c * values <= MAX_VALUES), None)
    wide = chunks is None
    return vec, values, wpr, chunks if not wide else need(wpr), wide


def fwd_plan(rows: int, h: int, itemsize: int, sms: int,
             aligned: bool = True) -> NormPlan:
    """The forward's plan for rows x [rows, h] of `itemsize` bytes on a
    card of `sms` SMs: the rows kernel as the backward's layout (blocks of
    8 warps, two an SM, or of 16, one an SM), its ring holding x alone;
    wide rows take the wide kernel at `warps_per_row`. Raises ValueError
    for arguments that describe no rows."""
    vec, values, wpr, chunks, wide = _layout("fwd_plan", rows, h, itemsize,
                                             sms, aligned)
    if wide:
        wpr = warps_per_row(h, itemsize)
        rpb = WARPS // wpr
        return NormPlan(h=h, vec=vec, wide=True, values=values, wpr=wpr,
                        chunks=-(-(h // values) // (32 * wpr)),
                        threads=32 * WARPS, rows_per_block=rpb, resident=0,
                        blocks=-(-rows // rpb), smem=rpb * h * itemsize,
                        in_flight=0)
    warps = max(WARPS, wpr)
    rpb = warps // wpr
    resident = WARPS_PER_SM // warps
    stage = rpb * h * itemsize if vec else 0
    return NormPlan(h=h, vec=vec, wide=False, values=values, wpr=wpr,
                    chunks=chunks, threads=32 * warps, rows_per_block=rpb,
                    resident=resident, blocks=resident * sms,
                    smem=RING * stage, in_flight=RING * stage * resident)


def bwd_plan(rows: int, h: int, itemsize: int, sms: int,
             aligned: bool = True) -> NormPlan:
    """The backward's plan for rows x [rows, h] of `itemsize` bytes on a
    card of `sms` SMs, laid out as `_layout` says; past 16 values a thread
    the wide kernel, 16 warps a row. Blocks of 8 warps, two an SM, or of 16
    when a row takes 16, one an SM. The ring holds x and dy, and its
    shared memory takes the column sums after the last row. Raises
    ValueError for arguments that describe no rows."""
    vec, values, wpr, chunks, wide = _layout("bwd_plan", rows, h, itemsize,
                                             sms, aligned)
    warps = max(WARPS, wpr)
    rpb = warps // wpr
    resident = WARPS_PER_SM // warps
    stage = rpb * 2 * h * itemsize if vec and not wide else 0
    sums = 0 if wide else 2 * rpb * h * 4  # LayerNorm's, as fp32
    return NormPlan(h=h, vec=vec, wide=wide, values=values, wpr=wpr,
                    chunks=chunks, threads=32 * warps, rows_per_block=rpb,
                    resident=resident, blocks=resident * sms,
                    smem=max(RING * stage, sums),
                    in_flight=(RING - 1) * stage * resident)


def _check(where: str, x: torch.Tensor, others: dict, params: dict):
    if x.dim() != 2 or x.dtype not in _DTYPES or not x.is_cuda:
        raise ValueError(f"{where}: x must be a CUDA [rows, h] tensor in "
                         f"bf16 or fp32, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    for name, t in {"x": x, **others}.items():
        if (t.device != x.device or t.dtype != x.dtype
                or t.shape != x.shape or not t.is_contiguous()):
            raise ValueError(f"{where}: {name} must be contiguous, shaped and "
                             "typed as x, on x's device")
    for name, t in params.items():
        if (t.device != x.device or t.dtype not in _DTYPES
                or tuple(t.shape) != (x.shape[1],) or not t.is_contiguous()):
            raise ValueError(f"{where}: {name} must be a contiguous [h] bf16 "
                             "or fp32 tensor on x's device")


def _vec(x: torch.Tensor, *tensors: torch.Tensor) -> int:
    """16-byte chunks when the row's bytes and every row base allow."""
    return int((x.shape[1] * x.element_size()) % 16 == 0
               and all(t.data_ptr() % 16 == 0 for t in (x, *tensors)))


def _fwd(wrapper, x, scale, bias, eps, layernorm):
    where = wrapper.__name__
    _check(where, x, {}, {"scale": scale, **({"bias": bias}
                                             if layernorm else {})})
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    rows, h = x.shape
    plan = fwd_plan(rows, h, x.element_size(),
                    cuda_build.sm_count(x.device.index),
                    aligned=bool(_vec(x, out)))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _library().fused_norm_fwd(
            x.data_ptr(), scale.data_ptr(),
            bias.data_ptr() if layernorm else None, out.data_ptr(),
            _DTYPES[x.dtype], _DTYPES[scale.dtype],
            _DTYPES[bias.dtype] if layernorm else 0, int(layernorm),
            int(plan.vec), rows, h, plan.wpr, 0 if plan.wide else plan.chunks,
            plan.blocks, plan.smem, float(eps), stream)
    cuda_build.raise_on(rc, where)
    wrapper.launches += 1
    return out


def _bwd(wrapper, x, scale, dy, eps, layernorm):
    where = wrapper.__name__
    _check(where, x, {"dy": dy}, {"scale": scale})
    rows, h = x.shape
    nsum = 2 if layernorm else 1
    dx = torch.empty_like(x)
    if x.numel() == 0:
        sums = x.new_zeros((nsum, 1, h), dtype=torch.float32)
        return dx, sums[0], sums[1] if layernorm else None
    plan = bwd_plan(rows, h, x.element_size(),
                    cuda_build.sm_count(x.device.index),
                    aligned=bool(_vec(x, dy, dx)))
    ws = torch.empty(nsum, plan.blocks, h, dtype=torch.float32,
                     device=x.device)
    sums = torch.empty(nsum, 1, h, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _library().fused_norm_bwd(
            x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            ws.data_ptr(), sums.data_ptr(), _DTYPES[x.dtype],
            _DTYPES[scale.dtype], int(layernorm), int(plan.vec), rows, h,
            plan.wpr, 0 if plan.wide else plan.chunks, plan.blocks,
            plan.smem, float(eps), stream)
    cuda_build.raise_on(rc, where)
    wrapper.launches += 1
    return dx, sums[0], sums[1] if layernorm else None


def rms_fwd_cuda(x: torch.Tensor, scale: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """RMSNorm of rows x [rows, h] (bf16 or fp32, contiguous) with scale
    [h] (bf16 or fp32): x * rsqrt(mean(x^2) + eps) * scale in x's dtype."""
    return _fwd(rms_fwd_cuda, x, scale, None, eps, False)


def rms_bwd_cuda(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                 eps: float):
    """Returns (dx [rows, h] in x's dtype, dscale [1, h] fp32 summed over
    the rows)."""
    dx, ds_part, _ = _bwd(rms_bwd_cuda, x, scale, dy, eps, False)
    return dx, ds_part


def ln_fwd_cuda(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
    """LayerNorm of rows x [rows, h] with scale and bias [h] (each bf16 or
    fp32): (x - mu) * rsqrt(var + eps) * scale + bias in x's dtype."""
    return _fwd(ln_fwd_cuda, x, scale, bias, eps, True)


def ln_bwd_cuda(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                eps: float):
    """Returns (dx, dscale, dbias), the sums fp32 [1, h]."""
    return _bwd(ln_bwd_cuda, x, scale, dy, eps, True)


KERNELS = (rms_fwd_cuda, rms_bwd_cuda, ln_fwd_cuda, ln_bwd_cuda)
for _fn in KERNELS:
    _fn.launches = 0


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}
