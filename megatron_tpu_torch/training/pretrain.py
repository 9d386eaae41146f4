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

Under torchrun the entry points train sharded over the (dp, pp, tp) mesh
of the ranks (`launch`), pipelined through BERT's spec or T5's pipelined
loss when pp > 1: every rank builds the same global batches, rank 0
builds the datasets' index caches first (`rank0_first`), the family's
module is built on the mesh, and its checkpoints are the unsharded
format (training/checkpointing.py).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch.distributed as dist

from megatron_tpu_torch.config import MegatronConfig
from megatron_tpu_torch.utils.device import DeviceLike, resolve_device


def launch(argv, extra_args=None, device: DeviceLike = None) -> tuple:
    """The flags and the ranks of an entry point -> (cfg, args, device,
    mesh): dp derived from torchrun's world, the process group joined
    (`--distributed_backend`), and the mesh built when there is more than
    one rank (None otherwise)."""
    from megatron_tpu_torch.arguments import parse_cli
    from megatron_tpu_torch.parallel.mesh import build_mesh
    from megatron_tpu_torch.parallel.multihost import (
        initialize_distributed, world_size)
    world = world_size()
    cfg, args = parse_cli(argv, extra_args, n_devices=world)
    device = initialize_distributed(device, args.distributed_backend)
    mesh = build_mesh(cfg.parallel) if world > 1 else None
    return cfg, args, device, mesh


@contextlib.contextmanager
def rank0_first(mesh):
    """Rank 0 runs the block (which builds the datasets' index caches)
    before the other ranks do."""
    if mesh is not None and mesh.rank != 0:
        dist.barrier()
    yield
    if mesh is not None and mesh.rank == 0:
        dist.barrier()


def run_pretrain(cfg: MegatronConfig, dataset, *, init_params_fn: Callable,
                 loss_fn: Callable, valid_dataset=None,
                 device: DeviceLike = None, mesh=None,
                 pipelined_spec: Optional[Callable] = None,
                 pipelined_loss_fn: Optional[Callable] = None) -> int:
    """Train on `dataset` on `device` (the current CUDA device when None;
    raises without one). `init_params_fn()` returns the family's fresh
    module on that device (built on `mesh` when one is given),
    `loss_fn(model, mb, generator)` the loss of one microbatch
    (make_train_step's contract); on a pipeline mesh the step and the
    evaluation run `pipelined_spec` or `pipelined_loss_fn` instead
    (make_train_step's). Returns 0."""
    from megatron_tpu_torch.data.samplers import (DictBatchIterator,
                                                  restore_data_state)
    from megatron_tpu_torch.training import checkpointing as ckpt
    from megatron_tpu_torch.training.loop import train
    from megatron_tpu_torch.training.train_step import state_from_params
    from megatron_tpu_torch.utils.logging import print_rank_0

    device = resolve_device(device)
    dp = 1 if mesh is None else mesh.shape["dp"]
    tr = cfg.training
    if cfg.data.test_data_path:
        print_rank_0("warning: --test_data_path is ignored by the "
                     "BERT/T5 pretrain entry points (no test phase)")

    model = init_params_fn()
    if getattr(model, "mesh", None) is not mesh:
        raise ValueError("run_pretrain: init_params_fn built its model on "
                         "another mesh than the one given")
    state = state_from_params(model, cfg)
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
            dataset, tr.micro_batch_size, dp, cfg.num_microbatches,
            consumed_samples=consumed_samples,
            dataloader_type=cfg.data.dataloader_type, seed=tr.seed)
        restore_data_state(it, data_state)
        return it

    valid_it = None
    if valid_dataset is not None:
        valid_it = DictBatchIterator(valid_dataset, tr.micro_batch_size, dp,
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
        step_kwargs={"loss_fn": loss_fn, "pipelined_spec": pipelined_spec,
                     "pipelined_loss_fn": pipelined_loss_fn},
        device=device)
    print_rank_0(f"pretraining done at consumed_samples={consumed}")
    return 0
