"""Build the evidence embedding index of open retrieval (REALM / ORQA): the
port of tools/create_doc_index.py. The biencoder's context tower (an npz
checkpoint under --load, from pretrain_ict or RET-FINETUNE-NQ) embeds a
DPR-style evidence TSV into the {row id: embedding} store that `tasks.main
--task NQ` searches.

  python -m megatron_tpu_torch.tools.create_doc_index --load ckpts/ict \\
      --evidence_data_path psgs_w100.tsv --embedding_path evidence.npz \\
      --tokenizer_type BertWordPieceLowerCase --vocab_file vocab.txt

Several processes: one a shard with --shard i --num_shards N, then one run
with --merge. It embeds on the current CUDA device; `main(argv,
device="cpu")` runs it on the CPU, and without a GPU and a `device` it
raises. An orbax checkpoint raises (ROADMAP Queue 1 item 2).
"""
from __future__ import annotations

import argparse
import sys

from megatron_tpu_torch.utils.device import DeviceLike, resolve_device


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("create_doc_index",
                                description=__doc__.splitlines()[0])
    p.add_argument("--load", required=True, help="biencoder checkpoint root")
    p.add_argument("--evidence_data_path", required=True)
    p.add_argument("--embedding_path", required=True)
    p.add_argument("--tokenizer_type", default="BertWordPieceLowerCase")
    p.add_argument("--vocab_file", default=None)
    p.add_argument("--merge_file", default=None)
    p.add_argument("--tokenizer_model", default=None)
    p.add_argument("--retriever_seq_length", type=int, default=256)
    p.add_argument("--indexer_batch_size", type=int, default=128)
    p.add_argument("--indexer_log_interval", type=int, default=10)
    p.add_argument("--ict_head_size", type=int, default=128)
    p.add_argument("--biencoder_shared_query_context_model",
                   action="store_true")
    p.add_argument("--shard", type=int, default=0)
    p.add_argument("--num_shards", type=int, default=1)
    p.add_argument("--merge", action="store_true",
                   help="merge the shard files of earlier runs and exit")
    # the model's shape when the checkpoint has no config
    p.add_argument("--num_layers", type=int, default=12)
    p.add_argument("--hidden_size", type=int, default=768)
    p.add_argument("--num_attention_heads", type=int, default=12)
    return p


def main(argv=None, *, device: DeviceLike = None) -> int:
    from megatron_tpu_torch.data.realm_index import OpenRetrievalDataStore

    device = resolve_device(device)
    args = get_parser().parse_args(argv)
    if args.merge:
        store = OpenRetrievalDataStore(args.embedding_path,
                                       load_from_path=False)
        store.merge_shards_and_save()
        print(f"merged {len(store)} block embeddings -> "
              f"{args.embedding_path}", flush=True)
        return 0

    from megatron_tpu_torch.data.orqa_dataset import \
        OpenRetrievalEvidenceDataset
    from megatron_tpu_torch.data.tokenizers import build_tokenizer
    from megatron_tpu_torch.indexer import IndexBuilder
    from megatron_tpu_torch.models.biencoder import load_biencoder

    tokenizer = build_tokenizer(
        args.tokenizer_type, vocab_file=args.vocab_file,
        merge_file=args.merge_file, tokenizer_model=args.tokenizer_model)
    model, mcfg = load_biencoder(args, tokenizer.vocab_size,
                                 args.retriever_seq_length, device)
    evidence = OpenRetrievalEvidenceDataset(
        args.evidence_data_path, tokenizer, args.retriever_seq_length)
    builder = IndexBuilder(
        model, mcfg, evidence, embedding_path=args.embedding_path,
        batch_size=args.indexer_batch_size, shard=args.shard,
        num_shards=args.num_shards, log_interval=args.indexer_log_interval,
        device=device)
    store = builder.build_and_save_index()
    print(f"indexed {len(store)} evidence blocks"
          + (f" (shard {args.shard}/{args.num_shards})"
             if args.num_shards > 1 else ""), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
