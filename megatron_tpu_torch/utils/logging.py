"""Logging and metric writers (megatron_tpu/utils/logging.py).

`print_rank_0` logs on the first process of a `torch.distributed` group, or
always when no group is initialised. `make_writer` returns a TensorBoard or
wandb writer on the last process, else a writer that drops everything. Both
packages are imported only when asked for; the card's machine has neither,
so asking for one there logs a warning and falls back to the null writer,
as the reference does when its package is missing.
"""
from __future__ import annotations

import logging
import sys
from typing import Optional

logger = logging.getLogger("megatron_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stdout)
    _h.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


def _rank_and_world() -> tuple[int, int]:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def print_rank_0(msg: str):
    """Log only on the first process."""
    if _rank_and_world()[0] == 0:
        logger.info(msg)


class NullWriter:
    def add_scalar(self, *a, **k):
        pass

    def add_text(self, *a, **k):
        pass

    def flush(self):
        pass


class TensorBoardWriter(NullWriter):
    """torch's SummaryWriter, imported at construction (it needs the
    `tensorboard` package)."""

    def __init__(self, log_dir: str):
        from torch.utils.tensorboard import SummaryWriter
        self._w = SummaryWriter(log_dir=log_dir)

    def add_scalar(self, tag, value, step):
        self._w.add_scalar(tag, float(value), int(step))

    def add_text(self, tag, text, step=0):
        self._w.add_text(tag, text, int(step))

    def flush(self):
        self._w.flush()


class WandbWriter(NullWriter):
    """TensorBoard-shaped wandb writer: buffers a step's scalars and commits
    them when the step advances."""

    def __init__(self, project: str = "megatron_tpu",
                 name: Optional[str] = None, config: Optional[dict] = None,
                 entity: Optional[str] = None, run_id: Optional[str] = None,
                 resume: bool = False):
        import wandb
        self._wandb = wandb
        self._run = wandb.init(
            project=project, name=name, config=config or {}, entity=entity,
            id=run_id, resume="must" if resume and run_id else
            ("allow" if resume else None))
        self._step = None
        self._buf: dict = {}

    def add_scalar(self, tag, value, step):
        if self._step is not None and step != self._step:
            self._wandb.log(self._buf, step=self._step)
            self._buf = {}
        self._step = step
        self._buf[tag] = float(value)

    def flush(self):
        if self._buf:
            self._wandb.log(self._buf, step=self._step)
            self._buf = {}


def make_writer(tensorboard_dir: Optional[str] = None,
                use_wandb: bool = False, **wandb_kwargs):
    """The writer of the last process; the others get a NullWriter."""
    rank, world = _rank_and_world()
    if rank != world - 1:
        return NullWriter()
    if use_wandb:
        try:
            return WandbWriter(**wandb_kwargs)
        except Exception as e:  # wandb not installed / no credentials
            logger.warning(f"wandb unavailable ({e}); falling back")
    if tensorboard_dir:
        try:
            return TensorBoardWriter(tensorboard_dir)
        except Exception as e:
            logger.warning(f"tensorboard unavailable ({e})")
    return NullWriter()


def report_memory(name: str = "", device=None) -> str:
    """One line of the CUDA allocator's allocated, peak and reserved bytes
    on `device`; "" on the CPU."""
    import torch
    if device is None or torch.device(device).type != "cuda":
        return ""
    gib = 1024 ** 3
    line = (f"[memory{' ' + name if name else ''}] "
            f"allocated {torch.cuda.memory_allocated(device) / gib:.2f} GiB"
            f" | peak {torch.cuda.max_memory_allocated(device) / gib:.2f} "
            f"GiB | reserved {torch.cuda.memory_reserved(device) / gib:.2f}"
            " GiB")
    print_rank_0(line)
    return line
