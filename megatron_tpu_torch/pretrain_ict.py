"""ICT (inverse cloze task) biencoder pretraining entry point (the port of
the root pretrain_ict.py).

  python -m megatron_tpu_torch.pretrain_ict --data_path data/sentences \\
      --titles_data_path data/titles --vocab_file vocab.txt \\
      --tokenizer_type BertWordPieceLowerCase --seq_length 256 \\
      --ict_head_size 128 --micro_batch_size 32 --bf16 \\
      --attention_impl flash --train_iters 10000 --save ckpts/ict

`--data_path` is a sentence-split indexed dataset (one sentence a row,
documents delimited by its doc_idx); `--titles_data_path` holds one title
row a document. ICTDataset (data/ict_dataset.py) draws a pseudo-query
sentence and its block; the loss is the in-batch softmax of
models/biencoder.py's `retrieval_loss`. The towers are forced to the BERT
family as the reference forces them, with fp32 master weights. It trains
on the current CUDA device; `main(argv, device="cpu")` runs it on the CPU,
and without a GPU and a `device` it raises. `--save` writes npz
checkpoints that the JAX package reads (`--no_save_optim` for the weights
alone), and `--load` resumes from one either package wrote.
"""
from __future__ import annotations

import dataclasses
import sys

from megatron_tpu_torch.utils.device import DeviceLike, resolve_device


def extra_args(p):
    p.add_argument("--titles_data_path", type=str, default=None)
    p.add_argument("--valid_titles_data_path", type=str, default=None,
                   help="titles of the --valid_data_path corpus (required "
                        "with it when --titles_data_path is given: titles "
                        "index a corpus's own documents)")
    p.add_argument("--ict_head_size", type=int, default=128)
    p.add_argument("--query_in_block_prob", type=float, default=0.1)
    p.add_argument("--biencoder_shared_query_context_model",
                   action="store_true")
    return p


def main(argv=None, *, device: DeviceLike = None) -> int:
    from megatron_tpu_torch.arguments import parse_cli
    from megatron_tpu_torch.data import build_tokenizer
    from megatron_tpu_torch.data.ict_dataset import ICTDataset
    from megatron_tpu_torch.data.indexed_dataset import MMapIndexedDataset
    from megatron_tpu_torch.models import biencoder
    from megatron_tpu_torch.pretrain_bert import single_prefix
    from megatron_tpu_torch.training.pretrain import run_pretrain
    from megatron_tpu_torch.utils.logging import print_rank_0

    device = resolve_device(device)
    cfg, args = parse_cli(argv, extra_args)
    tokenizer = build_tokenizer(
        cfg.data.tokenizer_type or "BertWordPieceLowerCase",
        vocab_file=cfg.data.vocab_file,
        tokenizer_model=cfg.data.tokenizer_model)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, use_rotary_emb=False, use_position_embedding=True,
        use_post_ln=True, use_bias=True, norm_type="layernorm",
        activation="gelu", tie_embed_logits=True, params_dtype="float32",
        vocab_size=tokenizer.vocab_size)).validate()
    mcfg = cfg.model
    shared = args.biencoder_shared_query_context_model
    towers = "shared" if shared else "separate"
    print_rank_0(f"device: {device} | ICT biencoder ({towers} towers): "
                 f"{mcfg.num_layers} layers, hidden "
                 f"{mcfg.hidden_size}, seq {mcfg.seq_length}, ict_head "
                 f"{args.ict_head_size}, attention {mcfg.attention_impl}")

    src = cfg.data.data_path or cfg.data.train_data_path
    if not src:
        raise SystemExit("--data_path (or --train_data_path) required")

    def make_ds(prefix, titles_path):
        sentences = MMapIndexedDataset(str(prefix))
        titles = MMapIndexedDataset(titles_path) if titles_path else None
        return ICTDataset(
            sentences, sentences.doc_idx, titles,
            max_seq_length=mcfg.seq_length,
            query_in_block_prob=args.query_in_block_prob,
            cls_id=tokenizer.cls, sep_id=tokenizer.sep,
            pad_id=tokenizer.pad, seed=cfg.training.seed,
            sizes=sentences.sizes)

    dataset = make_ds(single_prefix(src, "--data_path"),
                      args.titles_data_path)
    valid = None
    if cfg.data.valid_data_path:
        if args.titles_data_path and not args.valid_titles_data_path:
            raise SystemExit("--valid_data_path with --titles_data_path "
                             "requires --valid_titles_data_path")
        valid = make_ds(single_prefix(cfg.data.valid_data_path,
                                      "--valid_data_path"),
                        args.valid_titles_data_path)

    def init_params():
        return biencoder.BiencoderModel(
            mcfg, ict_head_size=args.ict_head_size, shared=shared,
            device=device, seed=cfg.training.seed, trainable=True)

    def loss_fn(model, mb, generator):
        loss, _ = biencoder.retrieval_loss(
            model, mb, mcfg, generator=generator,
            deterministic=mcfg.hidden_dropout == 0.0)
        return loss

    return run_pretrain(cfg, dataset, init_params_fn=init_params,
                        loss_fn=loss_fn, valid_dataset=valid, device=device)


if __name__ == "__main__":
    sys.exit(main())
