"""The shared pretraining routine of the non-GPT entry points
(megatron_tpu/training/pretrain.py): pretrain_bert.py and pretrain_t5.py
plug a model family in as (dataset, init_params_fn, loss_fn), and the
training step and loop are the GPT path's.

`run_pretrain` builds the state (or resumes it from `--load` / `--save`,
at the exact batch the interrupted run would have taken next), the batch
iterators over the family's dict samples, and the divergence-rollback
hooks: only checkpoints this run writes are rollback targets, and the data
stream is rebuilt at the checkpoint's exact position (the loop quarantines
the poison window; the order is never re-seeded).
"""
from __future__ import annotations

from typing import Callable

from megatron_tpu_torch.config import MegatronConfig
from megatron_tpu_torch.utils.device import DeviceLike, resolve_device


def run_pretrain(cfg: MegatronConfig, dataset, *, init_params_fn: Callable,
                 loss_fn: Callable, valid_dataset=None,
                 device: DeviceLike = None) -> int:
    """Train on `dataset` on `device` (the current CUDA device when None;
    raises without one). `init_params_fn()` returns the family's fresh
    module on that device, `loss_fn(model, mb, generator)` the loss of one
    microbatch (make_train_step's contract). Returns 0."""
    from megatron_tpu_torch.data.samplers import (DictBatchIterator,
                                                  restore_data_state)
    from megatron_tpu_torch.training import checkpointing as ckpt
    from megatron_tpu_torch.training.loop import train
    from megatron_tpu_torch.training.train_step import state_from_params
    from megatron_tpu_torch.utils.logging import print_rank_0

    device = resolve_device(device)
    tr = cfg.training
    if cfg.data.test_data_path:
        print_rank_0("warning: --test_data_path is ignored by the "
                     "BERT/T5 pretrain entry points (no test phase)")

    state = state_from_params(init_params_fn(), cfg)
    start_iteration, consumed = 0, 0
    data_state, quarantine = None, []
    load_dir = tr.load_dir or tr.checkpoint_dir
    if load_dir:
        loaded = ckpt.load_checkpoint(
            load_dir, state, finetune=tr.finetune,
            no_load_optim=tr.no_load_optim, resilience=cfg.resilience)
        _, start_iteration, consumed = loaded
        data_state, quarantine = loaded.data_state, loaded.quarantine

    def make_train_it(consumed_samples, data_state=None):
        it = DictBatchIterator(
            dataset, tr.micro_batch_size, 1, cfg.num_microbatches,
            consumed_samples=consumed_samples,
            dataloader_type=cfg.data.dataloader_type, seed=tr.seed)
        restore_data_state(it, data_state)
        return it

    valid_it = None
    if valid_dataset is not None:
        valid_it = DictBatchIterator(valid_dataset, tr.micro_batch_size, 1,
                                     cfg.num_microbatches, seed=tr.seed)

    save_fn = load_fn = None
    if tr.checkpoint_dir:
        def save_fn(st, iteration, consumed_samples, data_state=None,
                    quarantine=None):
            ckpt.save_checkpoint(tr.checkpoint_dir, st, cfg, iteration,
                                 consumed_samples, data_state=data_state,
                                 quarantine=quarantine)

        def load_fn():
            return ckpt.load_checkpoint(tr.checkpoint_dir, state,
                                        resilience=cfg.resilience)

    def reset_data_fn(consumed_samples, rollbacks, data_state=None):
        return make_train_it(consumed_samples, data_state)

    state, consumed = train(
        cfg, make_train_it(consumed, data_state), valid_it, state=state,
        start_iteration=start_iteration, consumed_samples=consumed,
        save_fn=save_fn, load_fn=load_fn, reset_data_fn=reset_data_fn,
        quarantine_log=quarantine,
        step_kwargs={"loss_fn": loss_fn},
        device=device)
    print_rank_0(f"pretraining done at consumed_samples={consumed}")
    return 0
