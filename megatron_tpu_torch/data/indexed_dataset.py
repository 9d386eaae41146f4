"""Indexed binary dataset: the `.bin` + `.idx` on-disk format.

A copy of megatron_tpu/data/indexed_dataset.py, which is numpy only; the
port keeps its own so that it never imports the JAX package. It writes the
same bytes, so a corpus preprocessed by either package serves both
(ref: megatron/data/indexed_dataset.py:341-600 MMapIndexedDataset,
:462-545 Builder/merge):

  .idx:  magic b"MMIDIDX\\x00\\x00" | u64 version=1 | u8 dtype_code
         | u64 num_sequences | u64 num_documents
         | i32 sizes[num_sequences]          (tokens per sequence)
         | i64 pointers[num_sequences]       (byte offset of each sequence)
         | i64 doc_idx[num_documents+1]      (sequence index of doc starts)
  .bin:  raw token arrays back to back, dtype per dtype_code.

Only the mmap implementation is provided — the reference's lazy/cached
variants (ref: indexed_dataset.py:128-263) existed for pre-mmap torch eras
and add nothing on a modern host.
"""
from __future__ import annotations

import os
import shutil
import struct
from typing import Optional, Sequence

import numpy as np

_MAGIC = b"MMIDIDX\x00\x00"
_HEADER_BYTES = 34  # magic(9) + version(8) + dtype(1) + len(8) + docs(8)


class DatasetCorruptionError(RuntimeError):
    """A `.idx`/`.bin` pair failed validation at open. Typed (never an
    assert — asserts vanish under `python -O` — and never a downstream
    numpy error) so callers can distinguish corrupt input data from
    code bugs; carries the offending path and an actionable message.
    `tools/validate_dataset.py` runs the same checks offline."""

    def __init__(self, path: str, reason: str):
        self.path = path
        self.reason = reason
        super().__init__(f"{path}: {reason}")

# dtype codes shared with the reference (ref: indexed_dataset.py:90-100)
DTYPES = {
    1: np.uint8,
    2: np.int8,
    3: np.int16,
    4: np.int32,
    5: np.int64,
    6: np.float32,
    7: np.float64,
    8: np.uint16,
}
DTYPE_CODES = {np.dtype(v): k for k, v in DTYPES.items()}


def data_file_path(prefix: str) -> str:
    return prefix + ".bin"


def index_file_path(prefix: str) -> str:
    return prefix + ".idx"


def infer_dataset_exists(prefix: str) -> bool:
    return (os.path.exists(data_file_path(prefix))
            and os.path.exists(index_file_path(prefix)))


def best_fitting_dtype(vocab_size: Optional[int]) -> np.dtype:
    """(ref: indexed_dataset.py:24-29) uint16 when the vocab fits."""
    if vocab_size is not None and vocab_size < 65500:
        return np.dtype(np.uint16)
    return np.dtype(np.int32)


class MMapIndexedDataset:
    """Read-side mmap dataset (ref: indexed_dataset.py:341-461).

    Validates the pair ON OPEN — header fields, index size arithmetic
    vs the actual `.idx` bytes, every pointer/size against the actual
    `.bin` bytes, doc_idx bounds + monotonicity — raising a typed
    `DatasetCorruptionError` up front instead of letting a truncated
    `.bin` or bit-rotted `.idx` surface 30 hours later as an
    inscrutable numpy error (or, worse, as silently garbage tokens)."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        idx_path = index_file_path(prefix)
        bin_path = data_file_path(prefix)
        for path in (idx_path, bin_path):
            # typed, so the blend-level skip-and-count policy catches a
            # half-deleted corpus the same way it catches a corrupt one
            if not os.path.isfile(path):
                raise DatasetCorruptionError(
                    path, "file missing — deleted corpus half or wrong "
                    "prefix; re-run preprocessing or fix --data_path")
        with open(idx_path, "rb") as f:
            header = f.read(_HEADER_BYTES)
        if len(header) < _HEADER_BYTES:
            raise DatasetCorruptionError(
                idx_path, f"index header truncated ({len(header)} of "
                f"{_HEADER_BYTES} bytes) — re-run preprocessing")
        magic = header[:9]
        if magic != _MAGIC:
            raise DatasetCorruptionError(
                idx_path, f"bad magic {magic!r} — not an indexed-dataset "
                "index file (overwritten header?); rebuild with "
                "tools/preprocess_data.py")
        (version,) = struct.unpack("<Q", header[9:17])
        if version != 1:
            raise DatasetCorruptionError(
                idx_path, f"unsupported index version {version} "
                "(expected 1) — corrupt header or a newer format")
        code = header[17]
        if code not in DTYPES:
            raise DatasetCorruptionError(
                idx_path, f"unknown dtype code {code} (valid: "
                f"{sorted(DTYPES)}) — corrupt header byte")
        self.dtype = np.dtype(DTYPES[code])
        (self._len,) = struct.unpack("<Q", header[18:26])
        (self._doc_count,) = struct.unpack("<Q", header[26:34])
        offset = _HEADER_BYTES

        # size arithmetic: the header fully determines the index length
        expected = (offset + 4 * self._len + 8 * self._len
                    + 8 * self._doc_count)
        actual = os.path.getsize(idx_path)
        if actual != expected:
            kind = ("truncated" if actual < expected
                    else "has trailing garbage")
            raise DatasetCorruptionError(
                idx_path, f"index size mismatch: header promises "
                f"{self._len} sequences + {self._doc_count} doc entries "
                f"= {expected} bytes, file has {actual} ({kind}) — "
                "re-run preprocessing")

        self._index_mmap = np.memmap(idx_path, mode="r", order="C")
        self.sizes = np.frombuffer(self._index_mmap, dtype=np.int32,
                                   count=self._len, offset=offset)
        offset += self.sizes.nbytes
        self._pointers = np.frombuffer(self._index_mmap, dtype=np.int64,
                                       count=self._len, offset=offset)
        offset += self._pointers.nbytes
        self.doc_idx = np.frombuffer(self._index_mmap, dtype=np.int64,
                                     count=self._doc_count, offset=offset)

        bin_size = os.path.getsize(bin_path)
        if self._len:
            if int(self.sizes.min()) < 0:
                i = int(np.argmin(self.sizes))
                raise DatasetCorruptionError(
                    idx_path, f"negative size {int(self.sizes[i])} at "
                    f"sequence {i} — corrupt sizes table")
            if int(self._pointers.min()) < 0:
                i = int(np.argmin(self._pointers))
                raise DatasetCorruptionError(
                    idx_path, f"negative pointer {int(self._pointers[i])} "
                    f"at sequence {i} — corrupt pointers table")
            # chunked scan: a single vectorized `pointers + sizes*item`
            # materializes O(len) int64 temporaries — multi-GB spikes on
            # billion-sequence corpora — for what is just a running max
            chunk = 1 << 22
            for lo in range(0, self._len, chunk):
                ends = (self._pointers[lo:lo + chunk]
                        + self.sizes[lo:lo + chunk].astype(np.int64)
                        * self.dtype.itemsize)
                if int(ends.max()) > bin_size:
                    i = lo + int(np.argmax(ends))
                    raise DatasetCorruptionError(
                        bin_path, f"sequence {i} spans bytes "
                        f"[{int(self._pointers[i])}, "
                        f"{int(self._pointers[i]) + int(self.sizes[i]) * self.dtype.itemsize}) "
                        f"but the data file is only {bin_size} bytes — "
                        "truncated .bin or stale index; re-run "
                        "preprocessing or restore the corpus")
        if self._doc_count:
            if (int(self.doc_idx.min()) < 0
                    or int(self.doc_idx.max()) > self._len):
                raise DatasetCorruptionError(
                    idx_path, "doc_idx entries outside "
                    f"[0, {self._len}] — corrupt document table")
            if self._doc_count > 1 and bool(
                    (np.diff(self.doc_idx) < 0).any()):
                raise DatasetCorruptionError(
                    idx_path, "doc_idx is not monotonically "
                    "non-decreasing — corrupt document table")
        self._data_mmap = np.memmap(bin_path, mode="r",
                                    order="C") if bin_size else \
            np.empty(0, dtype=np.uint8)

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, idx):
        if isinstance(idx, (int, np.integer)):
            ptr = self._pointers[idx]
            size = self.sizes[idx]
            return np.frombuffer(self._data_mmap, dtype=self.dtype,
                                 count=size, offset=ptr)
        raise TypeError(f"unsupported index type {type(idx)}")

    def get(self, idx: int, offset: int = 0, length: Optional[int] = None):
        """Read a slice of sequence `idx` (ref: indexed_dataset.py:436-446)."""
        size = int(self.sizes[idx])
        if length is None:
            length = size - offset
        ptr = int(self._pointers[idx]) + offset * self.dtype.itemsize
        return np.frombuffer(self._data_mmap, dtype=self.dtype, count=length,
                             offset=ptr)


class IndexedDatasetBuilder:
    """Write-side builder (ref: indexed_dataset.py:462-545)."""

    def __init__(self, prefix: str, dtype=np.int32):
        self.prefix = prefix
        self.dtype = np.dtype(dtype)
        self._data = open(data_file_path(prefix), "wb")
        self._sizes: list[int] = []
        self._doc_idx: list[int] = [0]

    def add_item(self, tokens: Sequence[int]) -> None:
        arr = np.asarray(tokens, dtype=self.dtype)
        self._data.write(arr.tobytes(order="C"))
        self._sizes.append(len(arr))

    def end_document(self) -> None:
        self._doc_idx.append(len(self._sizes))

    def merge_file(self, other_prefix: str) -> None:
        """Append another dataset with the same dtype
        (ref: indexed_dataset.py:524-538 merge_file_)."""
        other = MMapIndexedDataset(other_prefix)
        if other.dtype != self.dtype:
            raise ValueError(
                f"cannot merge {other_prefix} (dtype {other.dtype}) "
                f"into a {self.dtype} builder")
        base = len(self._sizes)
        self._sizes.extend(int(s) for s in other.sizes)
        # skip the leading 0 of the other doc_idx
        self._doc_idx.extend(base + int(d) for d in other.doc_idx[1:])
        with open(data_file_path(other_prefix), "rb") as f:
            shutil.copyfileobj(f, self._data)

    def finalize(self) -> None:
        self._data.close()
        sizes = np.asarray(self._sizes, dtype=np.int32)
        itemsize = self.dtype.itemsize
        pointers = np.zeros(len(sizes), dtype=np.int64)
        if len(sizes) > 1:
            np.cumsum(sizes[:-1] * itemsize, out=pointers[1:])
        if self._doc_idx[-1] != len(sizes):
            self._doc_idx.append(len(sizes))
        doc_idx = np.asarray(self._doc_idx, dtype=np.int64)
        with open(index_file_path(self.prefix), "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<Q", 1))
            f.write(struct.pack("<B", DTYPE_CODES[self.dtype]))
            f.write(struct.pack("<Q", len(sizes)))
            f.write(struct.pack("<Q", len(doc_idx)))
            f.write(sizes.tobytes(order="C"))
            f.write(pointers.tobytes(order="C"))
            f.write(doc_idx.tobytes(order="C"))


# handle cache keyed on (mtime_ns, size) of BOTH files — a plain
# lru_cache(prefix) kept serving stale (or corrupt) mmaps after the
# files were rewritten by re-preprocessing, and a failed open must
# never pin a broken entry
_DATASET_CACHE: dict = {}


def _file_signature(prefix: str) -> tuple:
    si = os.stat(index_file_path(prefix))
    sb = os.stat(data_file_path(prefix))
    return (si.st_mtime_ns, si.st_size, sb.st_mtime_ns, sb.st_size)


def _dataset_cache_clear() -> None:
    _DATASET_CACHE.clear()


def make_dataset(prefix: str, impl: str = "mmap") -> MMapIndexedDataset:
    """(ref: indexed_dataset.py:58-73 make_dataset) — mmap only.

    Re-validates freshness per call: the cached handle is reused only
    while both files' (mtime, size) are unchanged; a rewritten pair
    re-opens (and re-validates), a failed open evicts."""
    if impl not in ("mmap", "infer"):
        raise ValueError(f"only mmap supported, got {impl!r}")
    try:
        sig = _file_signature(prefix)
    except FileNotFoundError as e:
        _DATASET_CACHE.pop(prefix, None)
        raise DatasetCorruptionError(
            e.filename or prefix, "file missing — deleted corpus half "
            "or wrong prefix; re-run preprocessing or fix --data_path"
        ) from e
    hit = _DATASET_CACHE.get(prefix)
    if hit is not None and hit[0] == sig:
        return hit[1]
    _DATASET_CACHE.pop(prefix, None)  # stale or first open: drop first
    ds = MMapIndexedDataset(prefix)   # may raise DatasetCorruptionError
    _DATASET_CACHE[prefix] = (sig, ds)
    return ds


make_dataset.cache_clear = _dataset_cache_clear  # lru_cache-compat API
