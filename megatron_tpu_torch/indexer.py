"""The evidence-index builder: one pass of the biencoder's context tower
over an evidence corpus (megatron_tpu/indexer.py).

`IndexBuilder` embeds every passage of an `OpenRetrievalEvidenceDataset`
batch by batch on the device and fills an `OpenRetrievalDataStore` keyed by
row id (fp16, as the store keeps it). `shard` / `num_shards` give this
process a round-robin slice of the corpus; a sharded run saves its shard
and `OpenRetrievalDataStore.merge_shards_and_save` joins them.
"""
from __future__ import annotations

import torch

from megatron_tpu_torch.config import ModelConfig
from megatron_tpu_torch.data.orqa_dataset import OpenRetrievalEvidenceDataset
from megatron_tpu_torch.data.realm_index import OpenRetrievalDataStore
from megatron_tpu_torch.models.biencoder import embed_text, towers
from megatron_tpu_torch.utils.device import DeviceLike, resolve_device
from megatron_tpu_torch.utils.logging import print_rank_0


class IndexBuilder:
    """Embed the evidence blocks with `params`' context tower on `device`
    (the current CUDA device when None; raises without one) and fill a
    datastore at `embedding_path`."""

    def __init__(self, params, cfg: ModelConfig,
                 dataset: OpenRetrievalEvidenceDataset, *,
                 embedding_path: str, batch_size: int = 128, shard: int = 0,
                 num_shards: int = 1, log_interval: int = 10,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.dataset = dataset
        self.batch_size = batch_size
        self.shard, self.num_shards = shard, num_shards
        self.log_interval = log_interval
        self.store = OpenRetrievalDataStore(
            embedding_path, load_from_path=False, rank=shard)

    @torch.no_grad()
    def embed(self, batch: dict) -> torch.Tensor:
        """One batch of the dataset -> its context embeddings [b, d] fp32
        on the device."""
        def dev(key):
            return torch.from_numpy(batch[key]).to(self.device)
        _, context_tower = towers(self.params)
        return embed_text(context_tower, dev("context"), self.cfg,
                          padding_mask=dev("context_pad_mask"),
                          tokentype_ids=dev("context_types"))

    def build_and_save_index(self, save: bool = True
                             ) -> OpenRetrievalDataStore:
        """Embed every block of this shard into the store; save it (the
        shard file when sharded) unless `save` is False."""
        total = 0
        for it, batch in enumerate(self.dataset.batches(
                self.batch_size, shard=self.shard,
                num_shards=self.num_shards)):
            n = batch["n_real"]
            embeds = self.embed(batch)[:n].cpu().numpy()
            self.store.add_block_data(batch["row_id"][:n], embeds)
            total += n
            if self.log_interval and (it + 1) % self.log_interval == 0:
                print_rank_0(f"indexer: embedded {total} blocks")
        if save:
            if self.num_shards > 1:
                self.store.save_shard()
            else:
                self.store.save()
        return self.store
