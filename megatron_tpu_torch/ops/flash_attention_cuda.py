"""Build and binding of the Hopper flash-attention forward kernel.

The kernel (csrc/flash_fwd.cu) replaces the Pallas TPU kernel `_fwd_kernel`
of megatron_tpu/ops/flash_attention_pallas.py; its source note says what
bounds it on the card and what the design does about that.

`build()` compiles the source with nvcc for sm_90a into a shared library
under `build/` at the repository root, named by the source's hash, so a
changed source is rebuilt and an unchanged one is reused. `flash_fwd_cuda`
loads it through ctypes at first use, checks its inputs, launches on
PyTorch's current stream and raises on any launch error; it never falls
back to another implementation. `flash_fwd_cuda.launches` counts its
launches.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "flash_fwd.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the flash kernel is built on a "
                       "machine with the CUDA toolkit")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libflash_fwd_{digest}.so"


def build() -> Path:
    """Compile the kernel unless this source's library exists. The
    compiler's output (ptxas register and shared-memory use) is kept
    beside the library as `<name>.log`."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_fwd.argtypes = ([p] * 5 + [i] * 7 + [ll] * 9
                              + [ctypes.c_float, i, i, p])
    lib.flash_fwd.restype = i
    return lib


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, scale: float,
                   sliding_window: Optional[int] = None):
    """q [b, sq, nq, d], k/v [b, sk, nkv, d] on one CUDA device, bf16 or
    fp32, d in (64, 128), unit stride on d. Returns (out [b, sq, nq, d] in
    q's dtype, lse [b, nq, sq] fp32)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_fwd_cuda: {name} must lie on q's CUDA "
                             f"device, got {t.device}")
        if t.dtype != q.dtype:
            raise ValueError("flash_fwd_cuda: q, k and v must share a dtype")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"flash_fwd_cuda: {name} must be [b, s, n, d] "
                             "with unit stride on d")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_fwd_cuda: dtype {q.dtype} not supported "
                         "(bfloat16, float32)")
    b, sq, nq, d = q.shape
    _, sk, nkv, _ = k.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_fwd_cuda: head dim {d} not in {_HEAD_DIMS}")
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != d
            or nq % nkv):
        raise ValueError(f"flash_fwd_cuda: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not "
                         "form GQA attention")
    if sliding_window is not None and sliding_window <= 0:
        raise ValueError("flash_fwd_cuda: sliding_window must be > 0")
    if q.dtype == torch.bfloat16:
        # bf16 tiles load 16 bytes at a time, so every row must start on a
        # 16-byte boundary
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
                raise ValueError(
                    f"flash_fwd_cuda: bf16 {name} must start 16-byte aligned "
                    f"with strides in multiples of 8, got strides "
                    f"{t.stride()}")
    out = torch.empty(b, sq, nq, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, nq, sq, dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _DTYPE_CODES[q.dtype], d, b, sq, sk, nq, nkv,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            float(scale), int(causal), int(sliding_window or 0), stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd_cuda: launch failed with CUDA error "
                           f"{rc}")
    flash_fwd_cuda.launches += 1
    return out, lse


flash_fwd_cuda.launches = 0
