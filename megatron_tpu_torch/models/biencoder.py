"""The ICT / REALM biencoder: two BERT towers for retrieval
(megatron_tpu/models/biencoder.py).

- `BiencoderModel`: a query and a context tower ("query_model",
  "context_model"), or one tower for both ("shared_model"), each the BERT
  encoder and pooler without the pretraining heads, with an optional
  "ict_head" projecting the pooled output to `ict_head_size`;
- `embed_text`: one tower, tokens [b, s] -> fp32 embeddings [b, d];
- `retrieval_loss`: the in-batch softmax of scores q @ c^T / sqrt(d) with
  the diagonal as positives -> (loss, accuracy). On a model built on a
  (dp, tp) mesh (`biencoder_axes`) each dp rank scores its queries against
  the contexts of the whole microbatch, gathered over dp (the gather's
  backward sums every rank's grads, a reduce-scatter), as GSPMD scores the
  reference's, and returns its share of the loss and the accuracy; under
  sequence parallelism the pooler and the ict_head run on tp rank 0, where
  token 0 lies (models/bert.py);
- `MIPSIndex`: exact maximum-inner-product search over block embeddings
  on the device: fp32 `queries @ matrix.T` with TF32 off and
  `torch.topk`, chunked over the queries so that one block of scores stays
  within `score_bytes` (the reference scores every query at once, which at
  NQ-test's 3,610 queries over DPR's 21,015,324 passages is a 303 GB
  block). The chunks give the unchunked search's results: each query's
  row is scored and ranked alone;
- `load_biencoder`: the towers of a checkpoint, for the index and task
  entry points.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import numpy as np
import torch

from megatron_tpu_torch.config import ModelConfig, as_dtype
from megatron_tpu_torch.models.bert import (bert_axes, bert_config,
                                            bert_encode, bert_init,
                                            pooled_everywhere,
                                            strip_pretraining_heads)
from megatron_tpu_torch.models.classification import (EncoderTree, dense,
                                                      dense_spec)
from megatron_tpu_torch.parallel import collectives
from megatron_tpu_torch.parallel.mesh import DATA_AXIS
from megatron_tpu_torch.utils.device import DeviceLike, resolve_device

# one chunk's block of fp32 scores [queries, rows] at most
SCORE_BYTES = 4 << 30


class BiencoderModel(EncoderTree):
    """Separate query and context towers, or one shared tower."""

    def __init__(self, cfg: ModelConfig, *, ict_head_size: Optional[int] =
                 None, shared: bool = False, **kwargs):
        super().__init__(cfg, ict_head_size=ict_head_size, shared=shared,
                         **kwargs)
        self.stacked_prefixes = tuple(f"{t}.transformer." for t in self)

    @staticmethod
    def specs(cfg: ModelConfig, *, ict_head_size: Optional[int] = None,
              shared: bool = False) -> dict:
        tower = strip_pretraining_heads(bert_init(cfg))
        if ict_head_size is not None:
            tower["ict_head"] = dense_spec(cfg, ict_head_size)
        if shared:
            return {"shared_model": tower}
        return {"query_model": tower, "context_model": tower}

    @staticmethod
    def axes(cfg: ModelConfig, *, ict_head_size: Optional[int] = None,
             shared: bool = False) -> dict:
        return biencoder_axes(cfg, ict_head_size=ict_head_size,
                              shared=shared)

    @classmethod
    def options_from_tree(cls, shapes: dict) -> dict:
        shared = any(k.startswith("shared_model.") for k in shapes)
        head = ("shared_model" if shared else "query_model") + ".ict_head.w"
        return {"shared": shared,
                "ict_head_size": shapes[head][1] if head in shapes else None}


def biencoder_axes(cfg: ModelConfig, *, ict_head_size: Optional[int] = None,
                   shared: bool = False) -> dict:
    """Logical axes of the towers (biencoder.py biencoder_axes)."""
    tower = strip_pretraining_heads(bert_axes(cfg))
    if ict_head_size is not None:
        tower = dict(tower, ict_head={"w": ("embed", None), "b": (None,)})
    if shared:
        return {"shared_model": tower}
    return {"query_model": tower, "context_model": tower}


def towers(params):
    """(query tower, context tower); one tower twice when shared."""
    if "shared_model" in params:
        return params["shared_model"], params["shared_model"]
    return params["query_model"], params["context_model"]


def embed_text(tower, tokens: torch.Tensor, cfg: ModelConfig, *,
               padding_mask=None, tokentype_ids=None,
               generator: Optional[torch.Generator] = None,
               deterministic: bool = True, mesh=None) -> torch.Tensor:
    """One tower: tokens [b, s] -> the pooled output, through the ict_head
    when the tower has one, as fp32 [b, d] (on every tp rank of a
    `mesh`)."""
    _, pooled = bert_encode(tower, tokens, cfg, tokentype_ids=tokentype_ids,
                            padding_mask=padding_mask, generator=generator,
                            deterministic=deterministic, mesh=mesh)
    if "ict_head" in tower:
        pooled = dense(tower["ict_head"], pooled, as_dtype(cfg.compute_dtype))
    return pooled_everywhere(pooled, mesh).float()


def biencoder_forward(params, query_tokens: torch.Tensor,
                      context_tokens: torch.Tensor, cfg: ModelConfig, *,
                      query_pad_mask=None, context_pad_mask=None,
                      generator: Optional[torch.Generator] = None,
                      deterministic: bool = True):
    """-> (query embeddings [b, d], context embeddings [b, d]); one
    generator draws the query tower's dropout, then the context tower's."""
    mesh = getattr(params, "mesh", None)
    q_tower, c_tower = towers(params)
    q = embed_text(q_tower, query_tokens, cfg, padding_mask=query_pad_mask,
                   generator=generator, deterministic=deterministic,
                   mesh=mesh)
    c = embed_text(c_tower, context_tokens, cfg,
                   padding_mask=context_pad_mask, generator=generator,
                   deterministic=deterministic, mesh=mesh)
    return q, c


def retrieval_loss(params, batch: dict, cfg: ModelConfig, *,
                   generator: Optional[torch.Generator] = None,
                   deterministic: bool = True):
    """The in-batch softmax loss: row i's positive is context i. batch:
    query_tokens, context_tokens [b, s] and optionally query_pad_mask,
    context_pad_mask. Returns (loss, accuracy), fp32 scalars: on a mesh
    the rank's shares of them (see the module's note)."""
    mesh = getattr(params, "mesh", None)
    q, c = biencoder_forward(
        params, batch["query_tokens"], batch["context_tokens"], cfg,
        query_pad_mask=batch.get("query_pad_mask"),
        context_pad_mask=batch.get("context_pad_mask"), generator=generator,
        deterministic=deterministic)
    b = q.shape[0]
    labels = torch.arange(b, device=q.device)
    if mesh is not None:
        c = collectives.gather_axis(c, mesh, DATA_AXIS, 0)
        labels = labels + mesh.coords[DATA_AXIS] * b
    scores = q @ c.T / math.sqrt(q.shape[-1])
    logprobs = torch.log_softmax(scores, dim=-1)
    right = (scores.argmax(dim=-1) == labels).float()
    if mesh is None:
        return -logprobs.diagonal().mean(), right.mean()
    rows = b * mesh.shape[DATA_AXIS]
    picked = logprobs.gather(1, labels[:, None])
    return -picked.sum() / rows, right.sum() / rows


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for the matmuls inside (the flag is the process's)."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


class MIPSIndex:
    """Exact maximum-inner-product index over block embeddings, held as one
    fp32 [rows, d] matrix on `device` (the current CUDA device when None;
    raises without one)."""

    def __init__(self, embed_dim: int, *, device: DeviceLike = None,
                 score_bytes: int = SCORE_BYTES):
        self.embed_dim = embed_dim
        self.device = resolve_device(device)
        self.score_bytes = score_bytes
        self._ids: list[np.ndarray] = []
        self._embeds: list[torch.Tensor] = []
        self._matrix: Optional[torch.Tensor] = None
        self._row_ids: Optional[np.ndarray] = None

    def add_block_data(self, row_ids, block_embeds) -> None:
        """Append rows: ids [n] and embeddings [n, d] (numpy or a tensor,
        cast to fp32 on the index's device)."""
        embeds = torch.as_tensor(block_embeds).to(self.device, torch.float32)
        if embeds.shape[-1] != self.embed_dim:
            raise ValueError(f"embeddings of width {embeds.shape[-1]} for "
                             f"an index of width {self.embed_dim}")
        ids = np.asarray(row_ids, np.int64).ravel()
        embeds = embeds.reshape(-1, self.embed_dim)
        if len(ids) != len(embeds):
            raise ValueError(f"{len(ids)} ids for {len(embeds)} embeddings")
        self._ids.append(ids)
        self._embeds.append(embeds)
        self._matrix = self._row_ids = None  # joined at the next search

    def __len__(self) -> int:
        return sum(len(i) for i in self._ids)

    def chunk_rows(self) -> int:
        """Queries a chunk: as many as keep [queries, rows] fp32 scores
        within `score_bytes`, at least one."""
        return max(1, self.score_bytes // (4 * max(len(self), 1)))

    def _joined(self):
        if self._matrix is None:
            self._matrix = (self._embeds[0] if len(self._embeds) == 1
                            else torch.cat(self._embeds))
            self._embeds = [self._matrix]
            self._row_ids = np.concatenate(self._ids)
            self._ids = [self._row_ids]
        return self._matrix, self._row_ids

    @torch.no_grad()
    def search_device(self, query_embeds, top_k: int):
        """-> (scores [b, k] fp32, row positions [b, k] int64), on the
        device, sorted by descending score; k = min(top_k, rows)."""
        matrix, _ = self._joined()
        q = torch.as_tensor(query_embeds).to(self.device, torch.float32)
        k = min(top_k, len(matrix))
        rows = self.chunk_rows()
        scores, index = [], []
        with exact_fp32():
            for lo in range(0, len(q), rows):
                top = torch.topk(q[lo:lo + rows] @ matrix.T, k, dim=-1)
                scores.append(top.values)
                index.append(top.indices)
        return torch.cat(scores), torch.cat(index)

    def search_mips_index(self, query_embeds, top_k: int):
        """-> (scores [b, k], block ids [b, k]) as numpy arrays."""
        scores, index = self.search_device(query_embeds, top_k)
        _, row_ids = self._joined()
        return scores.cpu().numpy(), row_ids[index.cpu().numpy()]


def load_biencoder(args, vocab_size: int, seq_length: int,
                   device: DeviceLike = None):
    """The biencoder of the checkpoint under `args.load` on `device` ->
    (model, ModelConfig). `args` holds the retriever flags of the task and
    index entry points (--load, --ict_head_size,
    --biencoder_shared_query_context_model and the tower's shape); the
    config is the checkpoint's when it has one. An orbax checkpoint
    raises."""
    from megatron_tpu_torch.training.checkpointing import (
        load_checkpoint, load_config_from_checkpoint)
    from megatron_tpu_torch.training.train_step import TrainState

    cfg = load_config_from_checkpoint(args.load)
    mcfg = cfg.model.derived() if cfg is not None else bert_config(
        num_layers=args.num_layers, hidden_size=args.hidden_size,
        num_attention_heads=args.num_attention_heads, vocab_size=vocab_size,
        seq_length=seq_length, max_position_embeddings=seq_length,
        attention_impl="flash")
    model = BiencoderModel(mcfg, ict_head_size=args.ict_head_size,
                           shared=args.biencoder_shared_query_context_model,
                           device=device)
    loaded = load_checkpoint(args.load, TrainState(model, None, 0),
                             no_load_optim=True)
    if loaded.state is None:
        raise SystemExit(f"no biencoder checkpoint under {args.load}")
    return model, mcfg
