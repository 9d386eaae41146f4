"""BERT pretraining entry point (the port of the root pretrain_bert.py).

  python -m megatron_tpu_torch.pretrain_bert --data_path data/corpus \\
      --vocab_file vocab.txt --tokenizer_type BertWordPieceLowerCase \\
      --num_layers 12 --hidden_size 768 --num_attention_heads 12 \\
      --seq_length 512 --bf16 --attention_impl flash \\
      --micro_batch_size 8 --train_iters 10000 --save ckpts/bert

The corpus is one indexed-dataset prefix; BertDataset
(data/masked_dataset.py) draws its MLM + NSP samples from document halves.
The model family is forced as the reference forces it (post-LN, learned
positions, two token types, GELU, biases, a tied MLM decode), with fp32
master weights whatever `--bf16` asks of the compute. It trains on the
current CUDA device; `main(argv, device="cpu")` runs it on the CPU, as the
tests do, and without a GPU and a `device` it raises. Under torchrun it
trains sharded over the (dp, pp, tp) mesh of its ranks
(`--tensor_model_parallel_size`, `--pipeline_model_parallel_size`,
`--sequence_parallel`, `--use_distributed_optimizer`;
training/pretrain.py `launch`), pipelined through `bert_1f1b_fns` when
pp > 1, as pretrain_t5.py does through `t5_pipeline_loss_fn`
(pretrain_ict.py runs (dp, tp)). `--save` writes npz
checkpoints that the JAX package reads, and `--load` resumes from one
either package wrote, at the exact batch the interrupted run would have
taken next.
"""
from __future__ import annotations

import dataclasses
import sys

from megatron_tpu_torch.utils.device import DeviceLike


def single_prefix(paths, flag: str) -> str:
    """The one indexed-dataset prefix of `flag`: BERT and T5 pretraining
    read exactly one corpus (weighted blends are the GPT data path's)."""
    paths = list(paths)
    if len(paths) != 1:
        raise SystemExit(
            f"{flag} takes exactly one indexed-dataset prefix here (got "
            f"{paths}); weighted blending is only supported by the GPT data "
            "pipeline (finetune.py)")
    return paths[0]


def main(argv=None, *, device: DeviceLike = None) -> int:
    from megatron_tpu_torch.data import build_tokenizer
    from megatron_tpu_torch.data.indexed_dataset import MMapIndexedDataset
    from megatron_tpu_torch.data.masked_dataset import BertDataset
    from megatron_tpu_torch.models import bert
    from megatron_tpu_torch.training.pretrain import (launch, rank0_first,
                                                      run_pretrain)
    from megatron_tpu_torch.utils.logging import print_rank_0

    cfg, _, device, mesh = launch(argv, None, device)
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
    print_rank_0(f"device: {device} | BERT: {mcfg.num_layers} layers, "
                 f"hidden {mcfg.hidden_size}, seq {mcfg.seq_length}, vocab "
                 f"{mcfg.vocab_size}, attention {mcfg.attention_impl}")

    src = cfg.data.data_path or cfg.data.train_data_path
    if not src:
        raise SystemExit("--data_path (or --train_data_path) required")
    tr = cfg.training

    def make_ds(prefix, n_samples):
        return BertDataset(
            MMapIndexedDataset(str(prefix)), n_samples, mcfg.seq_length,
            tokenizer.vocab_size, cls_id=tokenizer.cls, sep_id=tokenizer.sep,
            mask_id=tokenizer.mask, pad_id=tokenizer.pad, seed=tr.seed,
            masked_lm_prob=cfg.data.masked_lm_prob)

    with rank0_first(mesh):
        dataset = make_ds(single_prefix(src, "--data_path"),
                          tr.train_iters * tr.global_batch_size)
        valid = None
        if cfg.data.valid_data_path:
            valid = make_ds(single_prefix(cfg.data.valid_data_path,
                                          "--valid_data_path"),
                            tr.eval_iters * tr.global_batch_size)

    def init_params():
        return bert.BertModel(mcfg, device=device, seed=tr.seed,
                              trainable=True, mesh=mesh)

    def loss_fn(model, mb, generator):
        return bert.bert_loss(model, mb, mcfg, generator=generator,
                              deterministic=mcfg.hidden_dropout == 0.0)

    # pp > 1: MLM and NSP pipelined through the 1F1B core
    return run_pretrain(cfg, dataset, init_params_fn=init_params,
                        loss_fn=loss_fn, valid_dataset=valid, device=device,
                        mesh=mesh, pipelined_spec=bert.bert_1f1b_fns)


if __name__ == "__main__":
    sys.exit(main())
