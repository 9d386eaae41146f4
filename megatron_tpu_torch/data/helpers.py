"""ctypes loader of the native data helpers (data/helpers.cpp).

Host C++, not a kernel: the sequential sample-index walk, the greedy
blending indices and the sentence-pair and ICT block mappings of
megatron_tpu/data/helpers.py. The library is built with
g++ at first use into the repository's `build/` directory (as
ops/cuda_build.py builds the kernels), named by the hash of its source and
flags, and never next to the source. A failed build raises; nothing falls
back to numpy.
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

import numpy as np

SOURCE = Path(__file__).resolve().parent / "helpers.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libdata_helpers_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile helpers.cpp unless its library exists; returns its path."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("g++ not found: the data helpers need a C++ "
                           "compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ {SOURCE.name} failed "
                               f"({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.build_sample_idx.argtypes = [
        i32p, i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, i32p]
    lib.build_sample_idx.restype = None
    lib.build_blending_indices.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int32, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64)]
    lib.build_blending_indices.restype = None
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.build_mapping.argtypes = [
        i64p, ctypes.c_int64, i32p, ctypes.c_int32, ctypes.c_uint64,
        ctypes.c_int32, ctypes.c_double, ctypes.c_int32, ctypes.c_int32,
        i64p]
    lib.build_mapping.restype = ctypes.c_int64
    lib.build_blocks_mapping.argtypes = [
        i64p, ctypes.c_int64, i32p, i32p, ctypes.c_int32, ctypes.c_uint64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, i64p]
    lib.build_blocks_mapping.restype = ctypes.c_int64
    return lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def build_sample_idx_native(sizes: np.ndarray, doc_idx: np.ndarray,
                            seq_length: int, num_epochs: int,
                            tokens_per_epoch: int) -> np.ndarray:
    """[num_samples+1, 2] int32 (doc_idx position, in-doc offset), walked
    sample by sample."""
    lib = _lib()
    sizes = np.ascontiguousarray(sizes, dtype=np.int32)
    doc_idx = np.ascontiguousarray(doc_idx, dtype=np.int32)
    num_samples = (num_epochs * tokens_per_epoch - 1) // seq_length
    out = np.zeros((num_samples + 1, 2), dtype=np.int32)
    lib.build_sample_idx(
        _ptr(sizes, ctypes.c_int32), _ptr(doc_idx, ctypes.c_int32),
        ctypes.c_int64(len(doc_idx)), ctypes.c_int32(seq_length),
        ctypes.c_int32(num_epochs), ctypes.c_int64(tokens_per_epoch),
        _ptr(out, ctypes.c_int32))
    return out


def build_blending_indices_native(weights: np.ndarray, size: int):
    """(dataset_index uint8 [size], dataset_sample_index int64 [size])."""
    lib = _lib()
    weights = np.ascontiguousarray(weights, dtype=np.float64)
    if len(weights) > 256:
        raise ValueError(f"at most 256 blended datasets, got {len(weights)}")
    dataset_index = np.zeros(size, dtype=np.uint8)
    dataset_sample_index = np.zeros(size, dtype=np.int64)
    lib.build_blending_indices(
        _ptr(weights, ctypes.c_double), ctypes.c_int32(len(weights)),
        ctypes.c_int64(size), _ptr(dataset_index, ctypes.c_uint8),
        _ptr(dataset_sample_index, ctypes.c_int64))
    return dataset_index, dataset_sample_index


def build_mapping_native(docs: np.ndarray, sizes: np.ndarray, *,
                         num_epochs: int, max_num_samples: int,
                         max_seq_length: int, short_seq_prob: float,
                         seed: int, min_num_sent: int = 2) -> np.ndarray:
    """Sentence-pair sample map [n, 3] int64 of (start sentence, end
    sentence, target length), shuffled."""
    lib = _lib()
    docs = np.ascontiguousarray(docs, dtype=np.int64)
    sizes = np.ascontiguousarray(sizes, dtype=np.int32)
    args = [_ptr(docs, ctypes.c_int64), ctypes.c_int64(len(docs) - 1),
            _ptr(sizes, ctypes.c_int32), ctypes.c_int32(num_epochs),
            ctypes.c_uint64(max_num_samples),
            ctypes.c_int32(max_seq_length),
            ctypes.c_double(short_seq_prob), ctypes.c_int32(seed),
            ctypes.c_int32(min_num_sent)]
    n = lib.build_mapping(*args, None)
    out = np.zeros((n, 3), dtype=np.int64)
    lib.build_mapping(*args, _ptr(out, ctypes.c_int64))
    return out


def build_blocks_mapping_native(docs: np.ndarray, sizes: np.ndarray,
                                titles_sizes: np.ndarray, *,
                                num_epochs: int, max_num_samples: int,
                                max_seq_length: int, seed: int,
                                use_one_sent_blocks: bool = False
                                ) -> np.ndarray:
    """ICT block map [n, 4] int64 of (start sentence, end sentence,
    document, block id), shuffled; a document's target length shrinks by
    its title's."""
    lib = _lib()
    docs = np.ascontiguousarray(docs, dtype=np.int64)
    sizes = np.ascontiguousarray(sizes, dtype=np.int32)
    titles_sizes = np.ascontiguousarray(titles_sizes, dtype=np.int32)
    args = [_ptr(docs, ctypes.c_int64), ctypes.c_int64(len(docs) - 1),
            _ptr(sizes, ctypes.c_int32), _ptr(titles_sizes, ctypes.c_int32),
            ctypes.c_int32(num_epochs), ctypes.c_uint64(max_num_samples),
            ctypes.c_int32(max_seq_length), ctypes.c_int32(seed),
            ctypes.c_int32(int(use_one_sent_blocks))]
    n = lib.build_blocks_mapping(*args, None)
    out = np.zeros((n, 4), dtype=np.int64)
    lib.build_blocks_mapping(*args, _ptr(out, ctypes.c_int64))
    return out
