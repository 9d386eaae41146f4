"""Build of the port's hand-written Hopper kernels.

`SOURCES` lists every kernel source under `csrc/`. `build()` compiles each
one whose library does not exist yet with nvcc for sm_90a, one nvcc process
per source, all started together, into a shared library with a plain C
interface under `build/` at the repository root. A library is named by the
hash of its source, the shared headers and the flags, so a changed source is
rebuilt and an unchanged one reused. The kernel wrappers load their library
through `library(name)` at first use and bind it with ctypes; building and
loading happen inside the call that needs them, never at import.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = {"flash_fwd": CSRC / "flash_fwd.cu",
           "flash_bwd": CSRC / "flash_bwd.cu",
           "block_attn": CSRC / "block_attn.cu",
           "fused_norms": CSRC / "fused_norms.cu"}
HEADERS = (CSRC / "flash_common.cuh", CSRC / "hopper.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the kernels are built on a machine "
                       "with the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for header in HEADERS:
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile every kernel source whose library does not exist yet, all in
    parallel. The compiler's output (ptxas register, shared-memory and
    spill lines) is kept beside each library as `<name>.log`. Returns
    {source name: library path}."""
    paths = {name: library_path(name) for name in SOURCES}
    todo = {name: path for name, path in paths.items() if not path.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    try:
        for name, out in todo.items():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
                 str(SOURCES[name])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs[name] = (proc, tmp, out)
        failures = []
        for name, (proc, tmp, out) in jobs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"nvcc {name} failed ({proc.returncode}):\n"
                                f"{log}")
                continue
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
        if failures:
            raise RuntimeError("\n".join(failures))
    finally:
        for proc, tmp, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return paths


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of one source (built first if needed)."""
    return ctypes.CDLL(str(build()[name]))


@functools.cache
def sm_count(index: int) -> int:
    """The streaming multiprocessors of CUDA device `index` (the kernels'
    persistent and split grids are sized by it)."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def raise_on(rc: int, where: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{where}: launch failed with CUDA error {rc}")
