"""The task entry point (tasks/main.py): the zero-shot GPT evaluations
(WIKITEXT103 perplexity, LAMBADA accuracy), GLUE (MNLI, QQP)
classification and RACE multiple-choice finetuning, the NQ retriever
evaluation and supervised retriever finetuning (RET-FINETUNE-NQ), with the
reference's flags and result lines.

  python -m megatron_tpu_torch.tasks.main --task MNLI \\
      --train_data train.tsv --valid_data dev_matched.tsv \\
      --tokenizer_type BertWordPieceLowerCase --vocab_file vocab.txt \\
      --seq_length 128 --micro_batch_size 32 --epochs 3
  python -m megatron_tpu_torch.tasks.main --task NQ --load ckpts/ict \\
      --valid_data nq-test.csv --evidence_data_path psgs_w100.tsv \\
      --embedding_path evidence.npz --vocab_file vocab.txt
  python -m megatron_tpu_torch.tasks.main --task WIKITEXT103 \\
      --valid_data wiki.test.tokens --load ckpts/gpt \\
      --tokenizer_type GPT2BPETokenizer --vocab_file vocab.json \\
      --merge_file merges.txt [--overlapping_eval 32]
  python -m megatron_tpu_torch.tasks.main --task LAMBADA \\
      --valid_data lambada.jsonl --load ckpts/gpt [--strict_lambada] ...

It runs on the current CUDA device; `main(argv, device="cpu")` runs it on
the CPU, and without a GPU and a `device` it raises. The BERT towers run
the flash kernels (the reference's tasks take the dot path, its config's
default), unless a checkpoint's config names another attention; the
zero-shot tasks run the checkpoint's own config (the GPT and Llama
presets take the flash kernels) on its npz weights.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from megatron_tpu_torch.utils.device import DeviceLike, resolve_device

FINETUNE_TASKS = ("MNLI", "QQP", "RACE")


def get_tasks_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("tasks", description=__doc__.splitlines()[0])
    p.add_argument("--task", required=True,
                   choices=["WIKITEXT103", "LAMBADA", *FINETUNE_TASKS, "NQ",
                            "RET-FINETUNE-NQ"],
                   help="NQ = the ORQA retriever evaluation; "
                        "RET-FINETUNE-NQ = supervised retriever finetuning")
    p.add_argument("--valid_data", nargs="+", required=True)
    p.add_argument("--train_data", nargs="*", default=None,
                   help="finetuning data (MNLI/QQP/RACE/RET-FINETUNE-NQ)")
    p.add_argument("--load", default=None,
                   help="checkpoint root (tracker + iter dirs)")
    p.add_argument("--pretrained_checkpoint", default=None,
                   help="pretraining checkpoint for the finetune tasks")
    p.add_argument("--tokenizer_type", default="HFTokenizer")
    p.add_argument("--tokenizer_model", default=None)
    p.add_argument("--vocab_file", default=None)
    p.add_argument("--merge_file", default=None)
    p.add_argument("--overlapping_eval", type=int, default=32)
    p.add_argument("--strict_lambada", action="store_true")
    p.add_argument("--micro_batch_size", type=int, default=8)
    p.add_argument("--seq_length", type=int, default=None,
                   help="sequence length of the finetune tasks (512); the "
                        "zero-shot tasks' window (the model's seq_length)")
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--lr", type=float, default=5e-5)
    # the model's shape when no checkpoint gives it
    p.add_argument("--num_layers", type=int, default=12)
    p.add_argument("--hidden_size", type=int, default=768)
    p.add_argument("--num_attention_heads", type=int, default=12)
    # the retriever
    p.add_argument("--evidence_data_path", default=None,
                   help="DPR-style evidence TSV (id, text, title)")
    p.add_argument("--embedding_path", default=None,
                   help="evidence embedding store (.npz) built by "
                        "megatron_tpu_torch.tools.create_doc_index")
    p.add_argument("--retriever_seq_length", type=int, default=256)
    p.add_argument("--faiss_topk_retrievals", type=int, default=100)
    p.add_argument("--faiss_match", default="string",
                   choices=["string", "regex"])
    p.add_argument("--ict_head_size", type=int, default=128)
    p.add_argument("--biencoder_shared_query_context_model",
                   action="store_true")
    # supervised retriever finetuning
    p.add_argument("--train_with_neg", action="store_true")
    p.add_argument("--train_hard_neg", type=int, default=0)
    p.add_argument("--val_av_rank_hard_neg", type=int, default=30)
    p.add_argument("--val_av_rank_other_neg", type=int, default=30)
    p.add_argument("--retriever_score_scaling", action="store_true")
    p.add_argument("--sample_rate", type=float, default=1.0,
                   help="subsample fraction of the supervised train set")
    return p


def build_cls_sep_tokenizer(args):
    """A tokenizer with [CLS]/[SEP]/[PAD] ids, or a clear error: the BERT
    tasks cannot run on a GPT-style tokenizer."""
    from megatron_tpu_torch.data.tokenizers import build_tokenizer
    tok_type = args.tokenizer_type
    if tok_type == "HFTokenizer" and args.vocab_file:
        tok_type = "BertWordPieceLowerCase"  # a bare --vocab_file
    tokenizer = build_tokenizer(
        tok_type, vocab_file=args.vocab_file, merge_file=args.merge_file,
        tokenizer_model=args.tokenizer_model)
    for attr in ("cls", "sep", "pad"):
        if getattr(tokenizer, attr, None) is None:
            raise SystemExit(
                f"--task {args.task} needs a tokenizer with [CLS]/[SEP]/"
                f"[PAD] ids (e.g. --tokenizer_type BertWordPieceLowerCase "
                f"--vocab_file vocab.txt); {tok_type} has no {attr!r}")
    return tokenizer


def task_config(args, vocab_size: int, seq: int):
    """The finetune tasks' MegatronConfig: BERT at the flags' shape."""
    from megatron_tpu_torch.config import (MegatronConfig, OptimizerConfig,
                                           TrainingConfig)
    from megatron_tpu_torch.models.bert import bert_config
    model = bert_config(
        num_layers=args.num_layers, hidden_size=args.hidden_size,
        num_attention_heads=args.num_attention_heads, vocab_size=vocab_size,
        seq_length=seq, max_position_embeddings=seq, attention_impl="flash")
    return MegatronConfig(
        model=model,
        optimizer=OptimizerConfig(lr=args.lr, clip_grad=1.0),
        training=TrainingConfig(micro_batch_size=args.micro_batch_size,
                                global_batch_size=args.micro_batch_size,
                                train_iters=1)).validate()


def run_finetune_task(args, device) -> dict:
    """MNLI / QQP classification and RACE multiple-choice finetuning."""
    from megatron_tpu_torch.tasks.finetune_utils import finetune_and_evaluate

    tokenizer = build_cls_sep_tokenizer(args)
    seq = args.seq_length or 512
    cfg = task_config(args, tokenizer.vocab_size, seq)
    if args.task in ("MNLI", "QQP"):
        from megatron_tpu_torch.tasks.glue.data import (GlueDataset,
                                                        read_mnli, read_qqp)
        read = read_mnli if args.task == "MNLI" else read_qqp
        train_rows = [r for p in (args.train_data or []) for r in read(p)]
        valid_rows = [r for p in args.valid_data for r in read(p)]
        train_ds = GlueDataset(train_rows, tokenizer, seq)
        valid_ds = GlueDataset(valid_rows, tokenizer, seq)
        kind, num_classes = "classification", (3 if args.task == "MNLI"
                                                else 2)
    else:
        from megatron_tpu_torch.tasks.race.data import RaceDataset, read_race
        train_rows = [r for p in (args.train_data or [])
                      for r in read_race(p)]
        valid_rows = [r for p in args.valid_data for r in read_race(p)]
        train_ds = RaceDataset(train_rows, tokenizer, seq)
        valid_ds = RaceDataset(valid_rows, tokenizer, seq)
        kind, num_classes = "multichoice", 4
    result = finetune_and_evaluate(
        cfg, train_ds, valid_ds, kind=kind, num_classes=num_classes,
        epochs=args.epochs, pretrained_checkpoint=args.pretrained_checkpoint,
        device=device)
    metrics = {"best accuracy": result["best_accuracy"],
               "last accuracy": result["last_accuracy"]}
    print(json.dumps({"task": args.task, **metrics}), flush=True)
    return metrics


def run_nq_task(args, device) -> dict:
    """The ORQA retriever evaluation: NQ top-k retrieval accuracy."""
    from megatron_tpu_torch.data.orqa_dataset import \
        OpenRetrievalEvidenceDataset
    from megatron_tpu_torch.data.tokenizers import build_tokenizer
    from megatron_tpu_torch.models.biencoder import load_biencoder
    from megatron_tpu_torch.tasks.orqa.evaluate import ORQAEvaluator

    if not args.load:
        raise SystemExit("--task NQ needs --load (biencoder checkpoint)")
    if not (args.evidence_data_path and args.embedding_path):
        raise SystemExit("--task NQ needs --evidence_data_path and "
                         "--embedding_path")
    tokenizer = build_tokenizer(
        args.tokenizer_type, vocab_file=args.vocab_file,
        merge_file=args.merge_file, tokenizer_model=args.tokenizer_model)
    model, mcfg = load_biencoder(args, tokenizer.vocab_size,
                                 args.retriever_seq_length, device)
    evidence = OpenRetrievalEvidenceDataset(
        args.evidence_data_path, tokenizer, args.retriever_seq_length)
    evaluator = ORQAEvaluator(model, mcfg, evidence_dataset=evidence,
                              embedding_path=args.embedding_path,
                              device=device)
    metrics = {}
    for path in args.valid_data:
        metrics[path] = evaluator.evaluate(
            path, tokenizer, seq_length=args.retriever_seq_length,
            top_k=args.faiss_topk_retrievals,
            batch_size=args.micro_batch_size, match_type=args.faiss_match)
    print(json.dumps({"task": "NQ", **metrics}), flush=True)
    return metrics


def run_ret_finetune_task(args, device) -> dict:
    """Supervised retriever finetuning on DPR-format NQ."""
    from megatron_tpu_torch.tasks.orqa.data import NQSupervisedDataset
    from megatron_tpu_torch.tasks.orqa.finetune import finetune_retriever

    tokenizer = build_cls_sep_tokenizer(args)
    seq = args.retriever_seq_length
    cfg = task_config(args, tokenizer.vocab_size, seq)
    train_ds = NQSupervisedDataset(
        args.train_data or [], tokenizer, seq,
        train_with_neg=args.train_with_neg,
        train_hard_neg=args.train_hard_neg, sample_rate=args.sample_rate)
    valid_ds = NQSupervisedDataset(
        args.valid_data, tokenizer, seq, evaluate=True,
        val_av_rank_hard_neg=args.val_av_rank_hard_neg,
        val_av_rank_other_neg=args.val_av_rank_other_neg)
    result = finetune_retriever(
        cfg, train_ds, valid_ds, epochs=args.epochs,
        score_scaling=args.retriever_score_scaling,
        pretrained_checkpoint=args.pretrained_checkpoint,
        ict_head_size=args.ict_head_size,
        shared=args.biencoder_shared_query_context_model, device=device)
    print(json.dumps({"task": "RET-FINETUNE-NQ", **result["final"]}),
          flush=True)
    return result["final"]


def run_zeroshot_task(args, device) -> dict:
    """WIKITEXT103 or LAMBADA on the npz checkpoint under --load: its
    config and weights, the window its seq_length unless --seq_length."""
    from megatron_tpu_torch.convert.from_jax import load_npz_checkpoint
    from megatron_tpu_torch.data.tokenizers import build_tokenizer
    from megatron_tpu_torch.tasks.zeroshot_gpt import evaluate as ev
    from megatron_tpu_torch.tasks.zeroshot_gpt.datasets import (
        build_lambada_dataset, build_wikitext_dataset)
    from megatron_tpu_torch.training.checkpointing import \
        load_config_from_checkpoint

    if not args.load:
        raise SystemExit("--load required for zero-shot tasks")
    cfg = load_config_from_checkpoint(args.load)
    if cfg is None:
        raise SystemExit(f"no checkpoint found under {args.load}")
    tokenizer = build_tokenizer(
        args.tokenizer_type, vocab_file=args.vocab_file,
        merge_file=args.merge_file, tokenizer_model=args.tokenizer_model)
    model, mcfg = load_npz_checkpoint(args.load, device)
    cfg = dataclasses.replace(cfg, model=mcfg)

    seq_len = args.seq_length or mcfg.seq_length
    path = args.valid_data[0]
    if args.task == "WIKITEXT103":
        ds = build_wikitext_dataset(path, tokenizer, seq_len,
                                    overlapping_eval=args.overlapping_eval)
    else:
        ds = build_lambada_dataset(path, tokenizer, seq_len,
                                   strict=args.strict_lambada)
    stats = ev.evaluate_dataset(model, ds, cfg,
                                batch_size=args.micro_batch_size,
                                device=device, log_every=10)
    metrics = (ev.wikitext_metrics(stats, ds) if args.task == "WIKITEXT103"
               else ev.lambada_metrics(stats))

    line = f" validation results on {args.task} | " + " | ".join(
        f"{k}: {v:.4E}" if isinstance(v, float) else f"{k}: {v}"
        for k, v in metrics.items())
    print("-" * (len(line) + 1))
    print(line)
    print("-" * (len(line) + 1))
    print(json.dumps({"task": args.task, **metrics}), flush=True)
    return metrics


def main(argv=None, *, device: DeviceLike = None) -> dict:
    """Run one task; returns its metrics."""
    device = resolve_device(device)
    args = get_tasks_parser().parse_args(argv)
    if args.task in FINETUNE_TASKS:
        return run_finetune_task(args, device)
    if args.task == "NQ":
        return run_nq_task(args, device)
    if args.task == "RET-FINETUNE-NQ":
        return run_ret_finetune_task(args, device)
    return run_zeroshot_task(args, device)


if __name__ == "__main__":
    main()
    sys.exit(0)
