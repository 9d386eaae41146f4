"""The pretraining entry point: pretrain or finetune a GPT, Llama or Falcon
model on an indexed corpus (the port of the root finetune.py).

  python -m megatron_tpu_torch.finetune --model llama2-7b --num_layers 2 \\
      --bf16 --use_flash_attn --data_path data/corpus_text_document \\
      --tokenizer_type GPT2BPETokenizer --vocab_file vocab.json \\
      --merge_file merges.txt --micro_batch_size 1 --global_batch_size 2 \\
      --train_iters 100 --save ckpts/run1

The flags are the reference's (arguments.py). It trains on the current CUDA
device; `main(argv, device="cpu")` runs it on the CPU, as the tests do, and
without a GPU and a `device` it raises. `--save` writes npz checkpoints that
the JAX package's `load_checkpoint` reads, and `--load` resumes from one
either package wrote, at the exact batch the interrupted run would have
taken next. `--step_timeout_s` arms the hung-step watchdog, which saves a
best-effort checkpoint and exits with `--watchdog_exit_code` (43). A
`MEGATRON_TPU_FAULTS` spec in the environment (resilience/faults.py
`FaultInjector.from_env`, e.g. `delay@3:30`) is active for the run: the
chaos drills of the resilience path run through this entry point.

`--lora_rank R` runs a LoRA finetune instead (training/lora.py): the
(possibly `--load`ed) base stays frozen, only rank-R adapter factors train
for `--train_iters` steps at `--lr`, and the adapter is exported to
`--lora_export` (default `<--save>/adapter.npz`, else `adapter.npz`) in the
`.npz` the serving bank loads (`--adapter_dir` of the serving tool).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys

from megatron_tpu_torch.utils.device import DeviceLike, resolve_device


def build_data(cfg, tokenizer, consumed_samples: int):
    """(train, valid, test) BatchIterators over the configured corpus; the
    train stream starts at `consumed_samples`."""
    from megatron_tpu_torch.data import (BatchIterator,
                                         build_train_valid_test_datasets)

    tr = cfg.training
    eval_iters = ((tr.train_iters // max(tr.eval_interval, 1)) + 1) \
        * tr.eval_iters
    samples = (tr.train_iters * tr.global_batch_size,
               eval_iters * tr.global_batch_size,
               tr.eval_iters * tr.global_batch_size)
    if cfg.data.train_data_path or cfg.data.valid_data_path \
            or cfg.data.test_data_path:
        # per-split corpora: each corpus is its split, --split is ignored
        def one(paths, n):
            if not paths:
                return None
            ds, _, _ = build_train_valid_test_datasets(
                list(paths), "1,0,0", cfg.model.seq_length, tr.seed,
                n, 0, 0, strict_data=cfg.data.strict_data)
            return ds
        train_ds = one(cfg.data.train_data_path or cfg.data.data_path,
                       samples[0])
        valid_ds = one(cfg.data.valid_data_path, samples[1])
        test_ds = one(cfg.data.test_data_path, samples[2])
    else:
        train_ds, valid_ds, test_ds = build_train_valid_test_datasets(
            cfg.data.data_path, cfg.data.split, cfg.model.seq_length,
            tr.seed, *samples, strict_data=cfg.data.strict_data)

    def make_iter(ds, consumed):
        if ds is None:
            return None
        return BatchIterator(
            ds, tr.micro_batch_size, 1, cfg.num_microbatches,
            consumed_samples=consumed,
            dataloader_type=cfg.data.dataloader_type, seed=tr.seed,
            eod_token=tokenizer.eod if tokenizer else None,
            reset_position_ids=cfg.data.reset_position_ids,
            reset_attention_mask=cfg.data.reset_attention_mask,
            eod_mask_loss=cfg.data.eod_mask_loss)

    return (make_iter(train_ds, consumed_samples), make_iter(valid_ds, 0),
            make_iter(test_ds, 0))


def main(argv=None, *, device: DeviceLike = None) -> int:
    from megatron_tpu_torch.arguments import parse_cli
    from megatron_tpu_torch.data import build_tokenizer, restore_data_state
    from megatron_tpu_torch.resilience import (FaultInjector,
                                               use_fault_injector)
    from megatron_tpu_torch.training import checkpointing as ckpt
    from megatron_tpu_torch.training import init_train_state
    from megatron_tpu_torch.training.loop import train
    from megatron_tpu_torch.utils.logging import print_rank_0

    device = resolve_device(device)
    cfg, args = parse_cli(argv)

    # --use_checkpoint_args: the architecture comes from the checkpoint
    if args.use_checkpoint_args and cfg.training.load_dir:
        loaded_cfg = ckpt.load_config_from_checkpoint(cfg.training.load_dir)
        if loaded_cfg is not None:
            cfg = dataclasses.replace(cfg, model=loaded_cfg.model).validate()
    print_rank_0(f"device: {device} | model: {cfg.model.num_layers} layers, "
                 f"hidden {cfg.model.hidden_size}, seq "
                 f"{cfg.model.seq_length}, attention "
                 f"{cfg.model.attention_impl}")

    tokenizer = None
    if cfg.data.tokenizer_model or cfg.data.vocab_file:
        tokenizer = build_tokenizer(
            cfg.data.tokenizer_type, vocab_file=cfg.data.vocab_file,
            merge_file=cfg.data.merge_file,
            tokenizer_model=cfg.data.tokenizer_model,
            vocab_extra_ids=cfg.data.vocab_extra_ids,
            vocab_extra_ids_list=cfg.data.vocab_extra_ids_list,
            new_tokens=cfg.data.new_tokens)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, vocab_size=tokenizer.vocab_size))

    state = init_train_state(cfg, seed=cfg.training.seed, device=device)
    start_iteration, consumed = 0, 0
    data_state, quarantine = None, []
    load_dir = cfg.training.load_dir or cfg.training.checkpoint_dir
    if load_dir:
        loaded = ckpt.load_checkpoint(
            load_dir, state, finetune=cfg.training.finetune,
            no_load_optim=cfg.training.no_load_optim,
            resilience=cfg.resilience)
        _, start_iteration, consumed = loaded
        data_state, quarantine = loaded.data_state, loaded.quarantine

    train_it, valid_it, _ = build_data(cfg, tokenizer, consumed)
    if train_it is None:
        raise ValueError("--data_path produced no training data")
    restore_data_state(train_it, data_state)

    if args.lora_rank:
        from megatron_tpu_torch.training.lora import run_lora_finetune
        export = args.lora_export or (
            os.path.join(cfg.training.checkpoint_dir, "adapter.npz")
            if cfg.training.checkpoint_dir else "adapter.npz")
        _, last_loss = run_lora_finetune(
            cfg, state.params, train_it, rank=args.lora_rank,
            alpha=args.lora_alpha, iters=cfg.training.train_iters,
            lr=cfg.optimizer.lr, seed=cfg.training.seed,
            export_path=export, log_interval=cfg.training.log_interval)
        print_rank_0(f"lora finetune done: final loss {last_loss:.4f}, "
                     f"adapter at {export}")
        return 0

    save_fn = load_fn = None
    if cfg.training.checkpoint_dir:
        def save_fn(st, iteration, consumed_samples, data_state=None,
                    quarantine=None):
            ckpt.save_checkpoint(cfg.training.checkpoint_dir, st, cfg,
                                 iteration, consumed_samples,
                                 data_state=data_state,
                                 quarantine=quarantine)

        # rollback restores only checkpoints this run writes (--save): the
        # --load base would bring back its own iteration and optimizer
        def load_fn():
            return ckpt.load_checkpoint(cfg.training.checkpoint_dir, state,
                                        resilience=cfg.resilience)

    def reset_data_fn(consumed_samples, rollbacks, data_state=None):
        it, _, _ = build_data(cfg, tokenizer, consumed_samples)
        restore_data_state(it, data_state)
        return it

    injector = FaultInjector.from_env()
    if injector is not None:
        print_rank_0(f"fault injection active: "
                     f"{os.environ[FaultInjector.ENV_VAR]}")
    with (use_fault_injector(injector) if injector is not None
          else contextlib.nullcontext()):
        state, consumed = train(
            cfg, train_it, valid_it, state=state,
            start_iteration=start_iteration, consumed_samples=consumed,
            save_fn=save_fn, load_fn=load_fn, reset_data_fn=reset_data_fn,
            quarantine_log=quarantine, device=device)
    print_rank_0(f"training done at consumed_samples={consumed}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
