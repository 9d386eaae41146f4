"""Process start-up and the global batch (megatron_tpu/parallel/multihost.py).

The reference runs one program per host over a global mesh: it joins the
JAX distributed runtime, every process builds the same global batch (same
seed, same sampler stream) and each keeps the dp rows its devices own. The
port does the same on torch.distributed:

1. `initialize_distributed()` joins the process group that torchrun
   describes in the environment (RANK, WORLD_SIZE, LOCAL_RANK,
   MASTER_ADDR, MASTER_PORT) and returns this rank's device: CUDA device
   LOCAL_RANK (modulo the visible devices) unless the caller names one.
   The backend is NCCL on a CUDA device; gloo when the caller names the
   CPU or names gloo. Outside torchrun it joins nothing.
2. `make_global_batch()` keeps this rank's dp rows of a global batch that
   every rank built alike.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from megatron_tpu_torch.parallel.mesh import DATA_AXIS, Mesh
from megatron_tpu_torch.utils.device import DeviceLike, resolve_device

BACKENDS = ("nccl", "gloo")


def initialize_distributed(device: DeviceLike = None,
                           backend: Optional[str] = None) -> torch.device:
    """Join torchrun's process group, once; returns this rank's device.
    Without a device, the CUDA device LOCAL_RANK % device_count becomes
    the current one (raises without a GPU). A process group that is
    already initialised is kept as it is."""
    env = os.environ
    if device is None:
        if not torch.cuda.is_available():
            resolve_device(None)  # raises: no CUDA device
        local_rank = int(env.get("LOCAL_RANK", "0"))
        device = torch.device("cuda",
                              local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    device = resolve_device(device)
    if dist.is_initialized() or "RANK" not in env:
        return device
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend runs on CUDA devices; name gloo "
                         "for the CPU")
    dist.init_process_group(backend, rank=int(env["RANK"]),
                            world_size=int(env["WORLD_SIZE"]))
    return device


def world_size() -> int:
    """The ranks of the run: the process group's, else what torchrun's
    WORLD_SIZE says (1 outside torchrun)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def process_batch_rows(mesh: Mesh, global_rows: int) -> tuple:
    """(row_lo, row_hi) of the global batch dim owned by this rank: its dp
    coordinate's equal share."""
    dp = mesh.shape[DATA_AXIS]
    if global_rows % dp:
        raise ValueError(f"global batch of {global_rows} rows does not "
                         f"split over dp={dp}")
    per = global_rows // dp
    lo = mesh.coords[DATA_AXIS] * per
    return lo, lo + per


def make_global_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's dp rows of a global batch: every leaf is [n_micro,
    global rows, ...], and each rank keeps rows `process_batch_rows` of
    every microbatch."""
    out = {}
    for k, v in batch.items():
        lo, hi = process_batch_rows(mesh, v.shape[1])
        out[k] = v[:, lo:hi]
    return out
