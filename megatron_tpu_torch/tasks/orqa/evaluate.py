"""The ORQA retriever evaluation: NQ top-k retrieval accuracy
(tasks/orqa/evaluate.py).

`ORQAEvaluator` embeds every question with the biencoder's query tower on
the device, searches the evidence store with the exact MIPS index
(models/biencoder.py, fp32 scores chunked over the questions) and counts
the questions whose answer occurs in one of their top-k passages
(tasks/orqa/qa_utils.py).
"""
from __future__ import annotations

import numpy as np
import torch

from megatron_tpu_torch.config import ModelConfig
from megatron_tpu_torch.data.orqa_dataset import (NQDataset,
                                                  OpenRetrievalEvidenceDataset)
from megatron_tpu_torch.data.realm_index import (OpenRetrievalDataStore,
                                                 build_mips_index)
from megatron_tpu_torch.models.biencoder import embed_text, towers
from megatron_tpu_torch.tasks.orqa.qa_utils import calculate_matches
from megatron_tpu_torch.utils.device import DeviceLike, resolve_device


class ORQAEvaluator:
    """Query tower + evidence store -> retrieval accuracies, on `device`
    (the current CUDA device when None; raises without one)."""

    def __init__(self, params, cfg: ModelConfig, *,
                 evidence_dataset: OpenRetrievalEvidenceDataset,
                 embedding_path: str, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.evidence_dataset = evidence_dataset
        store = OpenRetrievalDataStore(embedding_path, load_from_path=True)
        if not len(store):
            raise ValueError(f"empty embedding store at {embedding_path}")
        self.mips_index = build_mips_index(store, device=self.device)

    @torch.no_grad()
    def generate_query_vectors(self, qa_path: str, tokenizer,
                               seq_length: int, batch_size: int = 64):
        """-> (query embeddings [n, d] fp32 numpy, answer lists)."""
        dataset = NQDataset(qa_path, tokenizer, seq_length)
        query_tower, _ = towers(self.params)
        vecs, references = [], []
        for batch in dataset.batches(batch_size):
            def dev(key):
                return torch.from_numpy(batch[key]).to(self.device)
            q = embed_text(query_tower, dev("token_ids"), self.cfg,
                           padding_mask=dev("token_mask"),
                           tokentype_ids=dev("token_types"))
            vecs.append(q[:batch["n_real"]].cpu().numpy())
            references.extend(batch["reference"])
        query = np.concatenate(vecs, axis=0)
        assert len(query) == len(dataset)
        return query, references

    def evaluate(self, qa_path: str, tokenizer, *, seq_length: int = 64,
                 top_k: int = 100, batch_size: int = 64,
                 match_type: str = "string", split: str = "test") -> dict:
        """-> {"top1", "top5", "top20", "top100" (and f"top{top_k}")}: the
        share of questions answered within their first k passages."""
        query, references = self.generate_query_vectors(
            qa_path, tokenizer, seq_length, batch_size)
        scores, ids = self.mips_index.search_mips_index(query, top_k)
        closest = [(list(ids[i]), list(scores[i]))
                   for i in range(len(query))]
        stats = calculate_matches(self.evidence_dataset.id2text,
                                  references, closest,
                                  match_type=match_type)
        n = len(query)
        metrics = {}
        for k in sorted({1, 5, 20, 100} | {top_k}):
            if k <= len(stats.top_k_hits):
                metrics[f"top{k}"] = stats.top_k_hits[k - 1] / n
        line = f"Retriever eval ({split}): " + " | ".join(
            f"top-{k.lstrip('top')}: {v:.4f}" for k, v in metrics.items())
        print(line, flush=True)
        return metrics
