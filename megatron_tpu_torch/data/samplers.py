"""Pretraining samplers and the batch feeder.

A copy of megatron_tpu/data/samplers.py (host numpy; the port keeps its
own so that it never imports the JAX package). Both port
megatron/data/data_samplers.py (:48-95
MegatronPretrainingSampler, :119-186 random variant, :14-45
build_pretraining_data_loader). Semantics kept:

- sequential sampler resumes from `consumed_samples` (checkpoint resume
  fast-forwards the stream, ref: data_samplers.py:50-60);
- the random variant reshuffles per epoch with seed = base_seed + epoch
  (ref: data_samplers.py:119-166) and equally dp-shards the pool;
- drop_last batching.

Beyond the reference: every sampler/iterator here speaks the
`state_dict()` / `load_state_dict()` exact-resume protocol
(consumed_samples, epoch, shuffle seed, within-epoch cursor, prefetch
depth). The state rides in checkpoint metadata
(training/checkpointing.py) so an interrupted run — or a divergence
rollback (training/loop.py poison-batch quarantine) — replays the
IDENTICAL batch sequence instead of fast-forwarding by luck
(docs/resilience.md "Exact resume & poison-batch quarantine").

Difference by design: the reference yields per-dp-rank microbatches from a
per-rank torch DataLoader and broadcasts over TP (ref: training.py:855-939).
`BatchIterator` yields the whole batch as numpy arrays
{"tokens": [n_micro, micro_bs*dp, seq+1], ...}; the training loop copies it
to the device (training/loop.py).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class MegatronPretrainingSampler:
    """Sequential dp-sharded sampler (ref: data_samplers.py:48-95).
    Yields lists of global dataset indices, one per (micro_bs * dp) chunk.

    `consumed_samples` is the live within-epoch cursor: it advances as
    batches are yielded, so `state_dict()` taken at any batch boundary
    and restored via `load_state_dict()` resumes the identical stream
    (the exact-resume protocol, docs/resilience.md). `consumed_samples
    == total_samples` is a valid (empty) stream — a run checkpointed
    exactly at epoch end resumes by wrapping to the next epoch, not by
    crashing."""

    def __init__(self, total_samples: int, consumed_samples: int,
                 micro_batch_size: int, data_parallel_size: int,
                 drop_last: bool = True):
        if total_samples <= 0:
            raise ValueError(f"total_samples={total_samples} must be > 0")
        if not 0 <= consumed_samples <= total_samples:
            raise ValueError(
                f"consumed_samples={consumed_samples} outside "
                f"[0, {total_samples}] — the resume offset must be a "
                "within-epoch cursor (callers wrap epochs via "
                "BatchIterator)")
        self.total_samples = total_samples
        self.consumed_samples = consumed_samples
        self.micro_batch_times_dp = micro_batch_size * data_parallel_size
        self.drop_last = drop_last

    def __len__(self):
        return self.total_samples

    def __iter__(self):
        batch = []
        for idx in range(self.consumed_samples, self.total_samples):
            batch.append(idx)
            if len(batch) == self.micro_batch_times_dp:
                self.consumed_samples += self.micro_batch_times_dp
                yield batch
                batch = []
        if batch and not self.drop_last:
            self.consumed_samples += len(batch)
            yield batch

    def state_dict(self) -> dict:
        return {"consumed_samples": int(self.consumed_samples)}

    def load_state_dict(self, sd: dict) -> None:
        c = int(sd["consumed_samples"])
        if not 0 <= c <= self.total_samples:
            raise ValueError(
                f"sampler state consumed_samples={c} outside "
                f"[0, {self.total_samples}] — checkpoint from a "
                "different dataset?")
        self.consumed_samples = c


class MegatronPretrainingRandomSampler:
    """Per-epoch reshuffling sampler (ref: data_samplers.py:119-186).

    `consumed_samples` is GLOBAL (monotonic across epochs); the epoch
    and within-epoch cursor derive from it, so `state_dict()` /
    `load_state_dict()` resume the identical shuffled stream."""

    def __init__(self, total_samples: int, consumed_samples: int,
                 micro_batch_size: int, data_parallel_size: int,
                 seed: int = 1234):
        self.total_samples = total_samples
        self.consumed_samples = consumed_samples
        self.micro_batch_times_dp = micro_batch_size * data_parallel_size
        self.seed = seed
        self.last_batch_size = (self.total_samples
                                % self.micro_batch_times_dp)
        if self.total_samples - self.last_batch_size <= 0:
            raise ValueError(
                f"total_samples={total_samples} holds no full "
                f"micro_batch_size*dp={self.micro_batch_times_dp} batch")

    def __len__(self):
        return self.total_samples

    def __iter__(self):
        active_total = self.total_samples - self.last_batch_size
        self.epoch = self.consumed_samples // active_total
        current_epoch_samples = self.consumed_samples % active_total
        if current_epoch_samples % self.micro_batch_times_dp != 0:
            raise ValueError(
                f"consumed_samples={self.consumed_samples} is not "
                f"batch-aligned (micro_batch_size*dp="
                f"{self.micro_batch_times_dp})")

        g = np.random.RandomState(self.seed + self.epoch)
        idx_range = g.permutation(active_total)[current_epoch_samples:]

        batch = []
        for idx in idx_range:
            batch.append(int(idx))
            if len(batch) == self.micro_batch_times_dp:
                self.consumed_samples += self.micro_batch_times_dp
                yield batch
                batch = []

    def state_dict(self) -> dict:
        return {"consumed_samples": int(self.consumed_samples),
                "seed": int(self.seed)}

    def load_state_dict(self, sd: dict) -> None:
        if "seed" in sd and int(sd["seed"]) != self.seed:
            raise ValueError(
                f"sampler state was written with seed={sd['seed']}, "
                f"this run uses seed={self.seed} — the shuffled order "
                "differs; resume with the original --seed for a "
                "bit-exact replay")
        self.consumed_samples = int(sd["consumed_samples"])


class BatchIterator:
    """Assemble {"tokens", "loss_mask", "position_ids"} global batches of
    shape [n_micro, micro_bs*dp, ...] from a map-style dataset.

    The train loop's view of the data pipeline; replaces torch DataLoader +
    get_batch/broadcast_data (ref: finetune.py:65-90,
    core/tensor_parallel/data.py:65)."""

    def __init__(self, dataset, micro_batch_size: int, data_parallel: int,
                 num_microbatches: int, consumed_samples: int = 0,
                 dataloader_type: str = "single", seed: int = 1234,
                 drop_last: bool = True,
                 eod_token: Optional[int] = None,
                 reset_position_ids: bool = False,
                 reset_attention_mask: bool = False,
                 eod_mask_loss: bool = False):
        self.dataset = dataset
        self.num_microbatches = num_microbatches
        self.eod_token = eod_token
        self.reset_position_ids = reset_position_ids
        self.reset_attention_mask = reset_attention_mask
        self.eod_mask_loss = eod_mask_loss
        if not drop_last and num_microbatches > 1:
            # an epoch-tail partial microbatch cannot stack with the
            # wrapped epoch's full-size ones — the combination has no
            # rectangular batch; accumulate with drop_last instead
            raise ValueError(
                "drop_last=False requires num_microbatches == 1 "
                f"(got {num_microbatches})")
        self._sampler_args = (micro_batch_size, data_parallel, seed,
                              drop_last)
        self._dataloader_type = dataloader_type
        self._position(consumed_samples)

    def _make_sampler(self, consumed_samples: int):
        mbs, dp, seed, drop_last = self._sampler_args
        if self._dataloader_type == "single":
            return MegatronPretrainingSampler(
                len(self.dataset), consumed_samples, mbs, dp, drop_last)
        if self._dataloader_type == "cyclic":
            return MegatronPretrainingRandomSampler(
                len(self.dataset), consumed_samples, mbs, dp, seed)
        raise ValueError(f"unknown dataloader_type {self._dataloader_type!r}")

    def _epoch_len(self) -> int:
        """Samples one sequential epoch actually yields: drop_last drops
        the non-batch-aligned tail, so the resume modulus must be the
        aligned prefix — len(dataset) would leak dropped tail samples
        into the resumed stream's arithmetic."""
        chunk = self._sampler_args[0] * self._sampler_args[1]
        total = len(self.dataset)
        drop_last = self._sampler_args[3]
        return max(total - total % chunk if drop_last else total, 1)

    def _position(self, consumed_samples: int) -> None:
        """Rebuild the sampler at a monotonic consumed-samples count,
        deriving (epoch, within-epoch cursor). A resumed run past one
        epoch no longer crashes the sequential sampler's range check —
        the cursor wraps exactly as the live stream did."""
        self.samples_yielded = int(consumed_samples)
        if self._dataloader_type == "cyclic":
            # the random sampler's epoch arithmetic is internal (global
            # consumed_samples)
            self._epoch = 0
            self.sampler = self._make_sampler(consumed_samples)
        else:
            el = self._epoch_len()
            self._epoch = consumed_samples // el
            self.sampler = self._make_sampler(consumed_samples % el)
        self._it = iter(self.sampler)

    def state_dict(self) -> dict:
        """Exact-resume state at the current batch boundary: restored
        via `load_state_dict`, the stream replays the identical batch
        sequence (docs/resilience.md "exact resume & quarantine")."""
        mbs, dp, seed, drop_last = self._sampler_args
        return {
            "version": 1,
            "dataloader_type": self._dataloader_type,
            "seed": int(seed),
            "drop_last": bool(drop_last),
            "micro_batch_times_dp": int(mbs * dp),
            "dataset_len": int(len(self.dataset)),
            "epoch": int(self._epoch),
            "samples_yielded": int(self.samples_yielded),
            "sampler": self.sampler.state_dict(),
        }

    def load_state_dict(self, sd: dict) -> None:
        """Restore an exact stream position. Mismatched stream identity
        (dataloader type / seed / batch geometry) raises ValueError —
        silently resuming a DIFFERENT order would corrupt the replay
        guarantees the checkpoint promises."""
        mbs, dp, seed, drop_last = self._sampler_args
        for key, ours in (("dataloader_type", self._dataloader_type),
                          ("seed", int(seed)),
                          ("drop_last", bool(drop_last)),
                          ("micro_batch_times_dp", int(mbs * dp))):
            if key in sd and sd[key] != ours:
                raise ValueError(
                    f"data-iterator state mismatch: checkpoint has "
                    f"{key}={sd[key]!r}, this run uses {ours!r} — "
                    "resume with the original data configuration for a "
                    "bit-exact replay (or skip data-state restore to "
                    "accept a different order)")
        if (sd.get("dataset_len") is not None
                and int(sd["dataset_len"]) != len(self.dataset)):
            from megatron_tpu_torch.utils.logging import print_rank_0
            print_rank_0(
                f"warning: data-iterator state was written over "
                f"{sd['dataset_len']} samples, this dataset has "
                f"{len(self.dataset)} — epoch boundaries moved, the "
                "resumed order may not be bit-exact")
        self._epoch = int(sd.get("epoch", 0))
        self.samples_yielded = int(sd["samples_yielded"])
        self.sampler = self._make_sampler(0)
        self.sampler.load_state_dict(sd["sampler"])
        self._it = iter(self.sampler)

    def __iter__(self):
        return self

    def _next_indices(self):
        """One micro-batch of sample indices, wrapping epochs."""
        try:
            idxs = next(self._it)
        except StopIteration:
            if self._dataloader_type == "cyclic":
                # the random sampler's consumed_samples advanced during
                # iteration; re-iterating it starts the NEXT epoch with a
                # fresh seed+epoch permutation (ref: data_samplers.py:
                # 119-166)
                self._it = iter(self.sampler)
            else:
                # sequential wrap: restart from sample 0, NOT from the
                # resume offset — otherwise samples [0, consumed) would
                # be excluded from every later epoch
                self._epoch += 1
                self.sampler = self._make_sampler(0)
                self._it = iter(self.sampler)
            idxs = next(self._it)
        self.samples_yielded += len(idxs)
        return idxs

    def __next__(self) -> dict:
        micro = []
        full_rows = self._sampler_args[0] * self._sampler_args[1]
        for _ in range(self.num_microbatches):
            idxs = self._next_indices()
            if len(idxs) != full_rows:
                # partial tail batch (drop_last=False): it must still divide
                # dp, or the batch has no even split over the replicas
                dp = self._sampler_args[1]
                if len(idxs) % dp != 0:
                    raise ValueError(
                        f"drop_last=False tail batch of {len(idxs)} rows is "
                        f"not divisible by dp={dp}; either use drop_last="
                        "True or pad the dataset to a multiple of "
                        "micro_batch_size*dp")
            micro.append(np.stack(
                [np.asarray(self.dataset[i]["text"]) for i in idxs]))
        tokens = np.stack(micro).astype(np.int32)  # [n_micro, b, seq+1]
        batch = {"tokens": tokens}
        n_micro, b, sp1 = tokens.shape
        if ((self.reset_position_ids or self.reset_attention_mask or
             self.eod_mask_loss) and self.eod_token is not None):
            # helper runs on the INPUT tokens (tokens[:-1]); its loss_mask
            # zeroes positions whose input is EOD — i.e. it suppresses
            # predicting the next document's first token FROM the EOD,
            # matching ref: megatron/utils.py:137-194
            flat = tokens[:, :, :-1].reshape(n_micro * b, sp1 - 1)
            loss_mask, pos, seg = get_ltor_masks_and_position_ids(
                flat, self.eod_token,
                reset_position_ids=self.reset_position_ids,
                reset_attention_mask=self.reset_attention_mask,
                eod_mask_loss=self.eod_mask_loss)
            batch["loss_mask"] = loss_mask.reshape(n_micro, b, sp1 - 1)
            if self.reset_position_ids:
                batch["position_ids"] = pos.reshape(n_micro, b, sp1 - 1)
            if self.reset_attention_mask:
                batch["segment_ids"] = seg.reshape(n_micro, b, sp1 - 1)
        else:
            batch["loss_mask"] = np.ones(tokens[..., 1:].shape, np.float32)
        return batch


class DictBatchIterator:
    """Assemble [n_micro, micro_bs*dp, ...] batches from ANY map-style
    dataset yielding dict samples (BERT pairs, T5 spans, ICT query/context)
    — the generic counterpart of BatchIterator for non-GPT losses
    (ref: megatron/data/data_samplers.py build_pretraining_data_loader used
    by pretrain_bert/t5/ict)."""

    def __init__(self, dataset, micro_batch_size: int, data_parallel: int,
                 num_microbatches: int, consumed_samples: int = 0,
                 dataloader_type: str = "single", seed: int = 1234,
                 drop_last: bool = True):
        self.dataset = dataset
        self.num_microbatches = num_microbatches
        if not drop_last and num_microbatches > 1:
            # same rectangularity constraint as BatchIterator: a partial
            # tail microbatch cannot stack with full wrapped-epoch ones
            raise ValueError(
                "drop_last=False requires num_microbatches == 1 "
                f"(got {num_microbatches})")
        self._sampler_args = (micro_batch_size, data_parallel, seed,
                              drop_last)
        self._dataloader_type = dataloader_type
        # shared with BatchIterator: sequential resume derives
        # (epoch, within-epoch cursor) from the monotonic count — one
        # drop_last epoch emits only the batch-aligned prefix, so the
        # modulus is that epoch length; the random sampler takes the
        # GLOBAL count (its epoch arithmetic is internal)
        self._position(consumed_samples)

    _make_sampler = BatchIterator._make_sampler
    _epoch_len = BatchIterator._epoch_len
    _position = BatchIterator._position
    _next_indices = BatchIterator._next_indices
    state_dict = BatchIterator.state_dict
    load_state_dict = BatchIterator.load_state_dict

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        micro = []
        for _ in range(self.num_microbatches):
            idxs = self._next_indices()
            items = [self.dataset[i] for i in idxs]
            micro.append({k: np.stack([it[k] for it in items])
                          for k in items[0]})
        return {k: np.stack([m[k] for m in micro]) for k in micro[0]}


def restore_data_state(it, data_state) -> bool:
    """Position an iterator at a checkpoint's exact data state
    (`load_state_dict`). A mismatched state — different seed/geometry
    because the user changed the data config on purpose — degrades,
    loudly, to the consumed-samples fast-forward the iterator was
    already built with. Returns True only on an exact restore."""
    from megatron_tpu_torch.utils.logging import print_rank_0
    if it is None or not data_state:
        return False
    try:
        it.load_state_dict(data_state)
        return True
    except (ValueError, KeyError) as e:
        print_rank_0(f"warning: checkpoint data state not restored "
                     f"({e}); falling back to consumed-samples "
                     "fast-forward — the resumed batch order may "
                     "differ from the interrupted run")
        return False


def get_ltor_masks_and_position_ids(
    tokens: np.ndarray, eod_token: int,
    reset_position_ids: bool = False,
    reset_attention_mask: bool = False,
    eod_mask_loss: bool = False,
):
    """Loss mask / position ids with optional EOD resets
    (ref: megatron/utils.py:137-194 — the attention mask itself is built
    inside the attention op, so only its EOD-reset boundaries are
    returned here as segment ids for a block-diagonal mask)."""
    b, s = tokens.shape
    loss_mask = np.ones((b, s), np.float32)
    if eod_mask_loss:
        loss_mask[tokens == eod_token] = 0.0
    position_ids = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    segment_ids = np.zeros((b, s), np.int32)
    if reset_position_ids or reset_attention_mask:
        for bi in range(b):
            eods = np.where(tokens[bi] == eod_token)[0]
            prev = 0
            for si, e in enumerate(eods):
                if reset_position_ids:
                    position_ids[bi, e + 1:] -= (e + 1 - prev)
                if reset_attention_mask:
                    segment_ids[bi, e + 1:] = si + 1
                prev = e + 1
    return loss_mask, position_ids, segment_ids


class PrefetchIterator:
    """Background-thread batch prefetch: host-side sample assembly
    (tokenization, masks, index walks) overlaps device compute instead of
    sitting on the training step's critical path — the reference gets the
    same overlap from torch DataLoader worker processes
    (ref: data_samplers.py num_workers). Order-preserving; exceptions from
    the source iterator re-raise at the consuming call site; exhaustion
    keeps raising (the sentinel is re-armed). Call `close()` when done —
    the train loop does in its finally block — or the producer thread
    stays parked holding `depth` buffered batches.

    Batches stay HOST (numpy) arrays here: the train loop copies each
    one to the device on the MAIN thread, on the stream the step runs on,
    so the copy is ordered before the step that reads it (loop.py).

    NOT safe under batch-size rampup: buffered batches lag a
    num_microbatches change by up to `depth` steps, skewing the
    consumed-samples accounting, so loop.py only wraps when rampup is
    off (num_microbatches is then constant and the forwarding setter is
    a benign same-value write).

    Exact-resume state: the producer runs AHEAD of the consumer by up
    to `depth` batches, so the source iterator's live `state_dict()`
    over-counts what training has actually seen. The producer therefore
    snapshots the source state after pulling each batch and ships the
    pair through the queue; `state_dict()` returns the snapshot of the
    last batch DELIVERED to the consumer — checkpointing it resumes
    exactly at the next undelivered batch, never `depth` batches late.
    The producer thread starts lazily on the first `__next__`, so
    `load_state_dict()` before consumption is race-free."""

    _STOP = object()

    def __init__(self, it, depth: int = 2):
        import queue
        import threading
        self._queue_mod = queue
        self._threading_mod = threading
        self._it = it
        self.depth = max(depth, 1)
        self._q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        self._err = None
        self._closed = threading.Event()
        self._thread = None  # started on first __next__
        self._last_state = None  # source state at the last delivered batch

    @property
    def num_microbatches(self):
        return self._it.num_microbatches

    @num_microbatches.setter
    def num_microbatches(self, v):
        self._it.num_microbatches = v

    def state_dict(self):
        """Source iterator state at the CONSUMER's position (None when
        the source has no state protocol), tagged with the prefetch
        depth."""
        sd = self._last_state
        if sd is None:
            get_state = getattr(self._it, "state_dict", None)
            if get_state is None:
                return None
            sd = get_state()
        return {**sd, "prefetch_depth": int(self.depth)}

    def load_state_dict(self, sd) -> None:
        """Delegate to the source. Only legal before the producer has
        started (i.e. before the first `__next__`) — once batches are
        buffered, repositioning the source would splice two streams."""
        if self._thread is not None:
            raise RuntimeError(
                "load_state_dict on a running PrefetchIterator — "
                "restore the source iterator before wrapping it "
                "(or before consuming the first batch)")
        self._it.load_state_dict(sd)

    def _ensure_started(self):
        if self._thread is None and not self._closed.is_set():
            self._thread = self._threading_mod.Thread(
                target=self._run, daemon=True)
            self._thread.start()

    def _run(self):
        try:
            get_state = getattr(self._it, "state_dict", None)
            for batch in self._it:
                # snapshot AFTER the pull: the state a consumer resuming
                # past this batch needs (single-threaded producer — no
                # later pull can race the snapshot)
                state = get_state() if get_state is not None else None
                while not self._closed.is_set():
                    try:
                        self._q.put((batch, state), timeout=0.2)
                        break
                    except self._queue_mod.Full:
                        continue
                if self._closed.is_set():
                    return
        except BaseException as e:  # re-raised on the consumer side
            self._err = e
        finally:
            # the sentinel MUST land (a lost sentinel deadlocks the
            # consumer); keep trying unless close() is draining anyway
            while not self._closed.is_set():
                try:
                    self._q.put(self._STOP, timeout=0.2)
                    break
                except self._queue_mod.Full:
                    continue

    def close(self):
        """Stop the producer and release buffered batches."""
        self._closed.set()
        while True:  # drain so a blocked put wakes and sees the flag
            try:
                self._q.get_nowait()
            except self._queue_mod.Empty:
                break
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def __iter__(self):
        return self

    def __next__(self):
        self._ensure_started()
        item = self._q.get()
        if item is self._STOP:
            self._q.put(self._STOP)  # re-arm: every later call raises too
            if self._err is not None:
                raise self._err
            raise StopIteration
        batch, state = item
        if state is not None:
            self._last_state = state
        return batch
