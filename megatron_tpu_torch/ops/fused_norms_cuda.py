"""Binding of the Hopper fused-norm kernels.

csrc/fused_norms.cu replaces the four Pallas TPU kernels of
megatron_tpu/ops/fused_norms.py (`_rms_fwd_kernel`, `_rms_bwd_kernel`,
`_ln_fwd_kernel`, `_ln_bwd_kernel`); its note says what bounds them on the
card and what the design does about that. It is built with the other kernels
by ops/cuda_build.py. Each wrapper takes rows x [rows, h] (and dy), checks
its inputs, launches on PyTorch's current stream, raises on any launch
error (a row too wide for a block's shared memory among them), and counts
its launches in its `launches` attribute. The backward wrappers return fp32
partial sums [blocks, h] of dscale (and dbias), which the caller sums.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from megatron_tpu_torch.ops import cuda_build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# warps of a block (csrc/fused_norms.cu THREADS / 32); a row takes 1, 2, 4
# or 8 of them
WARPS = 8
# backward blocks per SM: the blocks stride over the row groups, so the
# dscale/dbias partials are [blocks, h] for any row count
BWD_BLOCKS_PER_SM = 2


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_build.library("fused_norms")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.fused_norm_fwd.argtypes = [p] * 4 + [i] * 5 + [ll, i, i, f, p]
    lib.fused_norm_fwd.restype = i
    lib.fused_norm_bwd.argtypes = [p] * 6 + [i] * 4 + [ll, i, i, i, f, p]
    lib.fused_norm_bwd.restype = i
    return lib


def warps_per_row(h: int, itemsize: int) -> int:
    """Warps owning one row: the fewest (1, 2, 4, 8) that leave each thread
    at most two 16-byte chunks, so a block holds 8 // wpr rows."""
    chunks = -(-h * itemsize // 16)
    wpr = 1
    while wpr < WARPS and 32 * wpr * 2 < chunks:
        wpr *= 2
    return wpr


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
    wpr = warps_per_row(x.shape[1], x.element_size())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _library().fused_norm_fwd(
            x.data_ptr(), scale.data_ptr(),
            bias.data_ptr() if layernorm else None, out.data_ptr(),
            _DTYPES[x.dtype], _DTYPES[scale.dtype],
            _DTYPES[bias.dtype] if layernorm else 0, int(layernorm),
            _vec(x, out), x.shape[0], x.shape[1], wpr, float(eps), stream)
    cuda_build.raise_on(rc, where)
    wrapper.launches += 1
    return out


def _bwd(wrapper, x, scale, dy, eps, layernorm):
    where = wrapper.__name__
    _check(where, x, {"dy": dy}, {"scale": scale})
    rows, h = x.shape
    dx = torch.empty_like(x)
    if x.numel() == 0:
        zeros = x.new_zeros((1, h), dtype=torch.float32)
        return dx, zeros, zeros.clone() if layernorm else None
    wpr = warps_per_row(h, x.element_size())
    groups = -(-rows // (WARPS // wpr))
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    blocks = max(1, min(groups, BWD_BLOCKS_PER_SM * sms))
    ds_part = torch.empty(blocks, h, dtype=torch.float32, device=x.device)
    db_part = torch.empty_like(ds_part) if layernorm else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _library().fused_norm_bwd(
            x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            ds_part.data_ptr(), db_part.data_ptr() if layernorm else None,
            _DTYPES[x.dtype], _DTYPES[scale.dtype], int(layernorm),
            _vec(x, dy, dx), rows, h, wpr, blocks, float(eps), stream)
    cuda_build.raise_on(rc, where)
    wrapper.launches += 1
    return dx, ds_part, db_part


def rms_fwd_cuda(x: torch.Tensor, scale: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """RMSNorm of rows x [rows, h] (bf16 or fp32, contiguous) with scale
    [h] (bf16 or fp32): x * rsqrt(mean(x^2) + eps) * scale in x's dtype."""
    return _fwd(rms_fwd_cuda, x, scale, None, eps, False)


def rms_bwd_cuda(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                 eps: float):
    """Returns (dx [rows, h] in x's dtype, dscale partials [blocks, h]
    fp32)."""
    dx, ds_part, _ = _bwd(rms_bwd_cuda, x, scale, dy, eps, False)
    return dx, ds_part


def ln_fwd_cuda(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
    """LayerNorm of rows x [rows, h] with scale and bias [h] (each bf16 or
    fp32): (x - mu) * rsqrt(var + eps) * scale + bias in x's dtype."""
    return _fwd(ln_fwd_cuda, x, scale, bias, eps, True)


def ln_bwd_cuda(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                eps: float):
    """Returns (dx, dscale partials, dbias partials), the partials fp32
    [blocks, h]."""
    return _bwd(ln_bwd_cuda, x, scale, dy, eps, True)


KERNELS = (rms_fwd_cuda, rms_bwd_cuda, ln_fwd_cuda, ln_bwd_cuda)
for _fn in KERNELS:
    _fn.launches = 0


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}
