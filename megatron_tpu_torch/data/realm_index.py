"""The block-embedding store of open retrieval (REALM / ORQA), a copy of
megatron_tpu/data/realm_index.py (numpy only): {row id: embedding}, fp16
on disk, saved as one compressed .npz (`ids` [N] int64 sorted, `embeds`
[N, d] float16), one such file a shard under `<path>_tmp/<rank>.npz`
before the merge. A store written by either package loads in the other.
`build_mips_index` loads a store into models/biencoder.py's MIPSIndex on
the device.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, Iterable, Optional

import numpy as np


class OpenRetrievalDataStore:
    """row_id -> block embedding, with shard/merge persistence
    (ref: realm_index.py:17-115). Embeddings are stored fp16 on disk like
    the reference (`embed_data[row_id] = np.float16(...)`,
    ref: realm_index.py:75-82)."""

    def __init__(self, embedding_path: Optional[str] = None,
                 load_from_path: bool = True, rank: Optional[int] = None):
        self.embed_data: Dict[int, np.ndarray] = {}
        self.embedding_path = embedding_path
        self.rank = rank
        if load_from_path and embedding_path and \
                os.path.exists(embedding_path):
            self.load_from_file()

    # -- shard temp-file naming (ref: realm_index.py:33-34,84-115) --
    @property
    def temp_dir_name(self) -> str:
        assert self.embedding_path
        return os.path.splitext(self.embedding_path)[0] + "_tmp"

    def state(self):
        return {"embed_data": self.embed_data}

    def clear(self):
        """(ref: realm_index.py:41-47)"""
        self.embed_data = {}

    def add_block_data(self, row_ids: Iterable[int], block_embeds,
                       allow_overwrite: bool = False):
        """(ref: realm_index.py:75-82)"""
        embeds = np.asarray(block_embeds, np.float16)
        for rid, emb in zip(np.asarray(row_ids).ravel(), embeds):
            rid = int(rid)
            if not allow_overwrite and rid in self.embed_data:
                raise ValueError(f"duplicate row id {rid} in datastore")
            self.embed_data[rid] = emb

    def __len__(self):
        return len(self.embed_data)

    def _pack(self):
        ids = np.fromiter(self.embed_data.keys(), np.int64,
                          len(self.embed_data))
        order = np.argsort(ids)
        ids = ids[order]
        mat = np.stack(list(self.embed_data.values()))[order] \
            if len(ids) else np.zeros((0, 0), np.float16)
        return ids, mat.astype(np.float16)

    def save_shard(self, rank: Optional[int] = None) -> str:
        """Write this process's embeddings into the temp shard dir
        (ref: realm_index.py:84-94 save_shard)."""
        rank = self.rank if rank is None else rank
        os.makedirs(self.temp_dir_name, exist_ok=True)
        path = os.path.join(self.temp_dir_name, f"{rank or 0}.npz")
        ids, mat = self._pack()
        np.savez_compressed(path, ids=ids, embeds=mat)
        return path

    def merge_shards_and_save(self, remove_temp: bool = True):
        """Combine all shard files into the final embedding_path
        (ref: realm_index.py:96-112 merge_shards_and_save)."""
        seen = 0
        for path in sorted(glob.glob(
                os.path.join(self.temp_dir_name, "*.npz"))):
            with np.load(path) as z:
                self.add_block_data(z["ids"], z["embeds"])
                seen += len(z["ids"])
        assert seen == len(self), \
            "duplicate row ids across datastore shards"
        self.save()
        if remove_temp:
            for path in glob.glob(os.path.join(self.temp_dir_name, "*.npz")):
                os.remove(path)
            os.rmdir(self.temp_dir_name)

    def save(self):
        assert self.embedding_path
        ids, mat = self._pack()
        np.savez_compressed(self.embedding_path, ids=ids, embeds=mat)

    def load_from_file(self):
        """(ref: realm_index.py:49-60)"""
        assert self.embedding_path
        with np.load(self.embedding_path) as z:
            self.embed_data = {int(i): e for i, e in
                               zip(z["ids"], z["embeds"])}


def build_mips_index(store: OpenRetrievalDataStore, embed_dim=None, *,
                     device=None):
    """Datastore -> exact matmul MIPS index on `device` (the current CUDA
    device when None; raises without one)."""
    from megatron_tpu_torch.models.biencoder import MIPSIndex
    ids, mat = store._pack()
    index = MIPSIndex(int(mat.shape[-1] if embed_dim is None else embed_dim),
                      device=device)
    if len(ids):
        index.add_block_data(ids, mat.astype(np.float32))
    return index
