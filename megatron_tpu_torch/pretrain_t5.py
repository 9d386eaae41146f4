"""T5 pretraining entry point (the port of the root pretrain_t5.py).

  python -m megatron_tpu_torch.pretrain_t5 --data_path data/corpus \\
      --vocab_file vocab.txt --tokenizer_type BertWordPieceLowerCase \\
      --num_layers 12 --hidden_size 768 --num_attention_heads 12 \\
      --seq_length 512 --decoder_seq_length 128 --vocab_extra_ids 100 \\
      --bf16 --attention_impl flash --micro_batch_size 8 \\
      --train_iters 10000 --save ckpts/t5

The corpus is one indexed-dataset prefix; T5Dataset
(data/masked_dataset.py) replaces spans with the `--vocab_extra_ids`
sentinels (default 100), which the tokenizer appends to its vocabulary.
The family is forced as the reference forces it (pre-LN LayerNorm, learned
positions, GELU, biases, a tied LM head), with fp32 master weights; the
decoder has `--num_layers` layers and `--decoder_seq_length` positions.
Devices and checkpoints as pretrain_bert.py.
"""
from __future__ import annotations

import dataclasses
import sys

from megatron_tpu_torch.pretrain_bert import single_prefix
from megatron_tpu_torch.utils.device import DeviceLike


def main(argv=None, *, device: DeviceLike = None) -> int:
    from megatron_tpu_torch.data import build_tokenizer
    from megatron_tpu_torch.data.indexed_dataset import MMapIndexedDataset
    from megatron_tpu_torch.data.masked_dataset import T5Dataset
    from megatron_tpu_torch.models import t5
    from megatron_tpu_torch.training.pretrain import (launch, rank0_first,
                                                      run_pretrain)
    from megatron_tpu_torch.utils.logging import print_rank_0

    cfg, _, device, mesh = launch(argv, None, device)
    extra_ids = cfg.data.vocab_extra_ids or 100
    tokenizer = build_tokenizer(
        cfg.data.tokenizer_type or "BertWordPieceLowerCase",
        vocab_file=cfg.data.vocab_file,
        tokenizer_model=cfg.data.tokenizer_model, vocab_extra_ids=extra_ids)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, use_rotary_emb=False, use_position_embedding=True,
        use_post_ln=False, use_bias=True, norm_type="layernorm",
        activation="gelu", tie_embed_logits=True, params_dtype="float32",
        vocab_size=tokenizer.vocab_size)).validate()
    mcfg = cfg.model
    print_rank_0(f"device: {device} | T5: {mcfg.num_layers} + "
                 f"{mcfg.num_layers} layers, hidden {mcfg.hidden_size}, seq "
                 f"{mcfg.seq_length} / {cfg.data.max_seq_length_dec}, vocab "
                 f"{mcfg.vocab_size}, attention {mcfg.attention_impl}")

    src = cfg.data.data_path or cfg.data.train_data_path
    if not src:
        raise SystemExit("--data_path (or --train_data_path) required")
    tr = cfg.training
    sentinels = list(range(tokenizer.vocab_size - extra_ids,
                           tokenizer.vocab_size))

    def make_ds(prefix, n_samples):
        return T5Dataset(
            MMapIndexedDataset(str(prefix)), n_samples, mcfg.seq_length,
            cfg.data.max_seq_length_dec, tokenizer.vocab_size,
            sentinel_ids=sentinels, bos_id=tokenizer.cls,
            eos_id=tokenizer.sep, pad_id=tokenizer.pad, seed=tr.seed,
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
        return t5.T5Model(mcfg, device=device, seed=tr.seed, trainable=True,
                          mesh=mesh)

    def loss_fn(model, mb, generator):
        return t5.t5_loss(model, mb, mcfg, generator=generator,
                          deterministic=mcfg.hidden_dropout == 0.0)

    pipelined_loss_fn = None
    if mesh is not None and cfg.parallel.pipeline_parallel > 1:
        # pp > 1: both stacks pipelined over pp
        def pipelined_loss_fn(model, batch, seeds, cotangent):
            return t5.t5_pipeline_loss_fn(
                model, batch, mcfg, vpp=cfg.parallel.virtual_pipeline_chunks,
                seeds=seeds, deterministic=mcfg.hidden_dropout == 0.0,
                cotangent=cotangent)

    return run_pretrain(cfg, dataset, init_params_fn=init_params,
                        loss_fn=loss_fn, valid_dataset=valid, device=device,
                        mesh=mesh, pipelined_loss_fn=pipelined_loss_fn)


if __name__ == "__main__":
    sys.exit(main())
