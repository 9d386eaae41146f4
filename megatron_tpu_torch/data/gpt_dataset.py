"""GPT pretraining dataset: doc/sample/shuffle index mappings.

A copy of megatron_tpu/data/gpt_dataset.py (host numpy); the port keeps its
own so that it never imports the JAX package. Both port GPTDataset
(ref: megatron/data/gpt_dataset.py:221-513).
The index-construction SEMANTICS are kept bit-identical — same RandomState
seed discipline, same separate-last-epoch rule, same sample walk with its
1-token overlap — because loss-curve comparability with the reference
requires sample-for-sample identical data order (SURVEY.md §7 hard parts).

The sample-index walk is O(num_samples) sequential in the reference and is
done by a C++ pybind helper (ref: megatron/data/helpers.cpp:83-166). Here the
fast path is the closed form: sample i starts at global token i*seq_length,
so (position, offset) = searchsorted over the cumulative doc lengths — fully
vectorized numpy, no native code needed for exactness when all docs are
non-empty. The port's copy of the C++ helper (data/helpers.cpp, built by
data/helpers.py) provides the exact sequential walk for corpora with empty
documents, where the JAX module takes it too.

Caching: mappings are built once and memory-mapped thereafter under the same
`{prefix}_{name}_indexmap_{ns}ns_{sl}sl_{seed}s_*.npy` naming scheme
(ref: gpt_dataset.py:285-292) so caches interchange with the reference.
"""
from __future__ import annotations

import os
import time
from typing import Sequence

import numpy as np

from megatron_tpu_torch.data.indexed_dataset import (DatasetCorruptionError,
                                               MMapIndexedDataset,
                                               make_dataset)
from megatron_tpu_torch.utils.logging import print_rank_0


def num_epochs_for(tokens_per_epoch: int, seq_length: int,
                   num_samples: int) -> int:
    """Smallest E with (E*tokens - 1) // seq_length >= num_samples
    (ref: gpt_dataset.py:415-427 _num_epochs; -1 for the 1-token overlap)."""
    assert tokens_per_epoch > 0
    e = 0
    total = 0
    while True:
        e += 1
        total += tokens_per_epoch
        if (total - 1) // seq_length >= num_samples:
            return e


def build_doc_idx(documents: np.ndarray, num_epochs: int,
                  np_rng: np.random.RandomState,
                  separate_last_epoch: bool) -> np.ndarray:
    """Shuffled concatenation of `num_epochs` copies of `documents`
    (ref: gpt_dataset.py:430-443). separate_last_epoch shuffles the final
    epoch independently so a partial last epoch still sees every doc."""
    if not separate_last_epoch or num_epochs == 1:
        idx = np.tile(np.asarray(documents, dtype=np.int32), num_epochs)
        np_rng.shuffle(idx)
        return idx
    first = build_doc_idx(documents, num_epochs - 1, np_rng, False)
    last = build_doc_idx(documents, 1, np_rng, False)
    return np.concatenate((first, last))


def build_sample_idx(sizes: np.ndarray, doc_idx: np.ndarray, seq_length: int,
                     num_epochs: int, tokens_per_epoch: int) -> np.ndarray:
    """[num_samples+1, 2] of (doc_idx position, in-doc offset) per sample
    (ref: gpt_dataset.py:446-493 _build_sample_idx / helpers.cpp:83-166).

    Closed form of the reference's walk: sample i spans global tokens
    [i*L, i*L + L] (1-token overlap), so its start position is a searchsorted
    over cumulative doc lengths. Falls back to the C++ sequential walk when
    empty documents make the closed form ambiguous."""
    doc_lens = sizes[doc_idx].astype(np.int64)
    if (doc_lens == 0).any():
        from megatron_tpu_torch.data.helpers import build_sample_idx_native
        return build_sample_idx_native(sizes, doc_idx, seq_length, num_epochs,
                                       tokens_per_epoch)
    num_samples = (num_epochs * tokens_per_epoch - 1) // seq_length
    starts = np.arange(num_samples + 1, dtype=np.int64) * seq_length
    cum = np.concatenate(([0], np.cumsum(doc_lens)))
    pos = np.searchsorted(cum, starts, side="right") - 1
    # the final entry may point one past the last doc when the stream divides
    # exactly; clamp like the sequential walk does (it never advances past a
    # doc it just finished without the -1 overlap)
    pos = np.minimum(pos, len(doc_idx) - 1)
    offs = starts - cum[pos]
    out = np.empty((num_samples + 1, 2), dtype=np.int32)
    out[:, 0] = pos
    out[:, 1] = offs
    return out


def build_shuffle_idx(num_samples: int, total_size: int,
                      np_rng: np.random.RandomState) -> np.ndarray:
    """(ref: gpt_dataset.py:496-513): shuffle [0, num_samples) and
    [num_samples, total_size) separately, concatenate."""
    dtype_ = np.uint32
    if total_size >= (np.iinfo(np.uint32).max - 1):
        dtype_ = np.int64
    first = np.arange(num_samples, dtype=dtype_)
    np_rng.shuffle(first)
    if num_samples == total_size:
        return first
    last = np.arange(num_samples, total_size, dtype=dtype_)
    np_rng.shuffle(last)
    return np.concatenate((first, last))


def build_index_mappings(name: str, data_prefix: str, documents: np.ndarray,
                         sizes: np.ndarray, num_samples: int, seq_length: int,
                         seed: int, cache: bool = True):
    """(ref: gpt_dataset.py:270-406 _build_index_mappings). One process
    builds; every process that shares the filesystem reuses the cache."""
    tokens_per_epoch = int(np.sum(sizes[documents]))
    num_epochs = num_epochs_for(tokens_per_epoch, seq_length, num_samples)
    np_rng = np.random.RandomState(seed=seed)

    base = (f"{data_prefix}_{name}_indexmap_{num_samples}ns_{seq_length}sl"
            f"_{seed}s")
    doc_f, sample_f, shuffle_f = (base + "_doc_idx.npy",
                                  base + "_sample_idx.npy",
                                  base + "_shuffle_idx.npy")

    if cache and all(os.path.isfile(f) for f in (doc_f, sample_f, shuffle_f)):
        doc_idx = np.load(doc_f, allow_pickle=True, mmap_mode="r")
        sample_idx = np.load(sample_f, allow_pickle=True, mmap_mode="r")
        shuffle_idx = np.load(shuffle_f, allow_pickle=True, mmap_mode="r")
        # a mapping cached against a previous version of the corpus can
        # name documents the current index no longer has (corpus
        # re-preprocessed smaller under the same prefix, or ids the
        # caller's out-of-bounds filtering just removed) — serving it
        # would bypass the skip-and-count policy and die downstream in
        # numpy instead of here
        if (doc_idx.size > 0 and int(doc_idx.min()) >= 0
                and int(doc_idx.max()) < len(sizes)):
            return doc_idx, sample_idx, shuffle_idx
        print_rank_0(f"warning: cached index mapping {base}_* names "
                     f"documents outside the current index of "
                     f"{len(sizes)} sequences (stale cache from a "
                     "rewritten corpus); rebuilding")

    t0 = time.time()
    if num_epochs == 1:
        separate_last_epoch = False
    else:
        # (ref: gpt_dataset.py:313-339) separate the last epoch from the
        # global shuffle when it contributes <80% of an epoch's samples
        samples_sans_last = ((num_epochs - 1) * tokens_per_epoch - 1
                             ) // seq_length
        last_epoch_samples = num_samples - samples_sans_last
        samples_per_epoch = (tokens_per_epoch - 1) // seq_length
        assert 0 <= last_epoch_samples <= samples_per_epoch + 1
        separate_last_epoch = (last_epoch_samples <
                               int(0.80 * samples_per_epoch))

    doc_idx = build_doc_idx(documents, num_epochs, np_rng,
                            separate_last_epoch)
    sample_idx = build_sample_idx(sizes, doc_idx, seq_length, num_epochs,
                                  tokens_per_epoch)
    if separate_last_epoch:
        n_shuffle = ((num_epochs - 1) * tokens_per_epoch - 1) // seq_length
    else:
        n_shuffle = sample_idx.shape[0] - 1
    shuffle_idx = build_shuffle_idx(n_shuffle, sample_idx.shape[0] - 1,
                                    np_rng)
    if not cache:
        return doc_idx, sample_idx, shuffle_idx
    np.save(doc_f, doc_idx, allow_pickle=True)
    np.save(sample_f, sample_idx, allow_pickle=True)
    np.save(shuffle_f, shuffle_idx, allow_pickle=True)
    print_rank_0(f"built index mappings for {name} in "
                 f"{time.time()-t0:.2f}s ({num_epochs} epochs, "
                 f"{sample_idx.shape[0]-1} samples)")
    doc_idx = np.load(doc_f, allow_pickle=True, mmap_mode="r")
    sample_idx = np.load(sample_f, allow_pickle=True, mmap_mode="r")
    shuffle_idx = np.load(shuffle_f, allow_pickle=True, mmap_mode="r")
    return doc_idx, sample_idx, shuffle_idx


class GPTDataset:
    """Map-style dataset of [seq_length+1]-token samples
    (ref: gpt_dataset.py:221-269).

    Document ids outside the index are SKIPPED and counted
    (`skipped_documents`, logged) by default — one bad split boundary
    or stale doc list must not kill a multi-week run; `strict_data=True`
    (`--strict_data`) fails fast with `DatasetCorruptionError` instead."""

    def __init__(self, name: str, data_prefix: str,
                 documents: np.ndarray, indexed: MMapIndexedDataset,
                 num_samples: int, seq_length: int, seed: int,
                 cache: bool = True, strict_data: bool = False):
        self.name = name
        self.data_prefix = data_prefix
        self.indexed = indexed
        documents = np.asarray(documents)
        oob = (documents < 0) | (documents >= len(indexed.sizes))
        self.skipped_documents = int(oob.sum())
        if self.skipped_documents:
            msg = (f"dataset {name}: {self.skipped_documents}/"
                   f"{documents.size} document ids out of bounds for an "
                   f"index of {len(indexed.sizes)} sequences (stale doc "
                   "split or corrupt index)")
            if strict_data:
                raise DatasetCorruptionError(
                    data_prefix, msg + " — re-run preprocessing, or drop "
                    "--strict_data to skip them")
            print_rank_0(f"warning: {msg}; skipping them "
                         "(--strict_data fails fast instead)")
            documents = documents[~oob]
        if documents.size == 0:
            raise DatasetCorruptionError(
                data_prefix, f"dataset {name}: no in-bounds documents "
                "left to sample from")
        self.doc_idx, self.sample_idx, self.shuffle_idx = build_index_mappings(
            name, data_prefix, documents, np.asarray(indexed.sizes),
            num_samples, seq_length, seed, cache=cache)
        self.seq_length = seq_length

    def __len__(self) -> int:
        # -1 because sample i needs sample_idx[i+1] (ref: gpt_dataset.py:244)
        return self.sample_idx.shape[0] - 1

    def __getitem__(self, idx: int) -> dict:
        """(ref: gpt_dataset.py:248-269) gather seq_length+1 tokens spanning
        one or more documents."""
        idx = self.shuffle_idx[idx]
        doc_index_f, offset_f = self.sample_idx[idx]
        doc_index_l, offset_l = self.sample_idx[idx + 1]
        if doc_index_f == doc_index_l:
            sample = self.indexed.get(self.doc_idx[doc_index_f],
                                      offset=int(offset_f),
                                      length=int(offset_l - offset_f + 1))
        else:
            parts = [self.indexed.get(self.doc_idx[doc_index_f],
                                      offset=int(offset_f))]
            for i in range(doc_index_f + 1, doc_index_l):
                parts.append(self.indexed[self.doc_idx[i]])
            parts.append(self.indexed.get(self.doc_idx[doc_index_l],
                                          length=int(offset_l + 1)))
            sample = np.concatenate(parts)
        if len(sample) != self.seq_length + 1:
            # typed (not an assert: gone under python -O) — a
            # wrong-length sample means the on-disk index and data
            # disagree, and silently feeding it would corrupt training
            raise DatasetCorruptionError(
                self.data_prefix,
                f"dataset {self.name}: sample {idx} gathered "
                f"{len(sample)} tokens, want {self.seq_length + 1} — "
                "index/data mismatch (was the corpus rewritten under a "
                "cached index mapping?)")
        return {"text": sample.astype(np.int64)}


def get_train_valid_test_split_(splits_string: str, size: int):
    """'969,30,1' -> index boundaries (ref: megatron/data/dataset_utils.py
    get_train_valid_test_split_ semantics)."""
    splits = [float(s) for s in splits_string.replace("/", ",").split(",")]
    while len(splits) < 3:
        splits.append(0.0)
    splits = splits[:3]
    total = sum(splits)
    assert total > 0.0
    splits = [s / total for s in splits]
    splits_index = [0]
    for s in splits:
        splits_index.append(splits_index[-1] + int(round(s * float(size))))
    diff = splits_index[-1] - size
    for i in range(1, len(splits_index)):
        splits_index[i] -= diff
    assert splits_index[-1] == size
    return splits_index


def build_train_valid_test_datasets(
    data_prefix: Sequence, splits_string: str, seq_length: int, seed: int,
    train_samples: int, valid_samples: int, test_samples: int,
    cache: bool = True, strict_data: bool = False,
):
    """(ref: gpt_dataset.py:20-127). Single prefix or weighted blend
    [w0, p0, w1, p1, ...].

    Corrupt-data policy (`strict_data` / `--strict_data`): a blend
    prefix that fails validation (`DatasetCorruptionError`) is skipped
    with a loud count and the surviving prefixes re-weighted — unless
    strict, which fails fast. A single (sole-source) corrupt prefix
    always raises: there is nothing left to train on."""
    from megatron_tpu_torch.data.blendable import BlendableDataset, \
        normalize_blend_weights

    if len(data_prefix) == 1:
        return _single_train_valid_test(
            data_prefix[0], splits_string, seq_length, seed,
            (train_samples, valid_samples, test_samples), cache,
            strict_data)

    prefixes, weights = normalize_blend_weights(data_prefix)
    counts = (train_samples, valid_samples, test_samples)
    # (dataset, weight) pairs per split so a prefix that yields no data for
    # one split cannot shift the weights of the survivors
    per_ds: list[list] = [[], [], []]
    per_w: list[list] = [[], [], []]
    skipped_prefixes: list[str] = []
    for prefix, w in zip(prefixes, weights):
        n = tuple(int(np.ceil(w * c * 1.005)) for c in counts)
        try:
            tr, va, te = _single_train_valid_test(
                prefix, splits_string, seq_length, seed, n, cache,
                strict_data)
        except DatasetCorruptionError as e:
            if strict_data:
                raise
            skipped_prefixes.append(prefix)
            print_rank_0(f"warning: skipping corrupt blend prefix "
                         f"({e}); surviving prefixes re-weighted "
                         "(--strict_data fails fast instead)")
            continue
        for i, d in enumerate((tr, va, te)):
            if d is not None:
                per_ds[i].append(d)
                per_w[i].append(w)
    if skipped_prefixes and not any(per_ds):
        raise DatasetCorruptionError(
            ", ".join(skipped_prefixes),
            f"all {len(skipped_prefixes)} blend prefixes failed "
            "validation — no data left to train on")
    if skipped_prefixes:
        print_rank_0(f"blend: skipped {len(skipped_prefixes)}/"
                     f"{len(prefixes)} corrupt prefixes: "
                     f"{', '.join(skipped_prefixes)}")
    out = []
    for lst, ws, c in zip(per_ds, per_w, counts):
        out.append(BlendableDataset(lst, ws, c) if lst and c > 0 else None)
    return tuple(out)


def _single_train_valid_test(prefix, splits_string, seq_length, seed, counts,
                             cache, strict_data=False):
    indexed = make_dataset(prefix)
    total_docs = indexed.doc_idx.shape[0] - 1
    splits = get_train_valid_test_split_(splits_string, total_docs)
    names = ("train", "valid", "test")
    out = []
    for i, name in enumerate(names):
        if splits[i + 1] > splits[i] and counts[i] > 0:
            documents = np.arange(splits[i], splits[i + 1], dtype=np.int32)
            out.append(GPTDataset(name, prefix, documents, indexed, counts[i],
                                  seq_length, seed, cache=cache,
                                  strict_data=strict_data))
        else:
            out.append(None)
    return tuple(out)
