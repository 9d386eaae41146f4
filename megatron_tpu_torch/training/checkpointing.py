"""Checkpoint save and load with Megatron's resume semantics
(megatron_tpu/training/checkpointing.py, its npz backend).

The layout and files are the JAX package's, so a checkpoint moves between the
two packages with no converter:

- `latest_checkpointed_iteration.txt` names the newest checkpoint (an
  iteration number or "release"), written atomically;
- `iter_{N:07d}/` (or `release/`) holds `params.npz`, `opt_state.npz`,
  `metadata.json` (iteration, consumed_samples, `format_version` 1, the data
  iterator's exact-resume `data_state` and the quarantined windows) and
  `config.json` (`MegatronConfig.to_json`, the reference's section names);
- a SHA-256 `manifest.json` seals the directory before the tracker names it
  (resilience/integrity.py); a load verifies it and falls back to the newest
  valid checkpoint; retention keeps the newest `keep_last_k`. Every file
  write and the tracker read are retried, and each is a fault point
  (`checkpoint_write`, `tracker_read`, resilience/faults.py) where an
  active injector raises a transient error for the retry to absorb.

The npz keys are exactly the names JAX's `_flatten` gives its trees: the
parameter tree's paths ("transformer/attention/wq", the port's state_dict
names with "/" for "."), and for the optimizer `step`, `mu/...`, `nu/...`,
`scaler/scale`, `scaler/growth_tracker` and `scaler/hysteresis`. The
iteration lives in `metadata.json`. A save copies one leaf at a time from the
device into the zip, so the host never holds more than a leaf; a load checks
every key and shape before it reads, then copies each leaf into the example
state's tensors in place. The step's random draws derive from (seed,
iteration) (training/loop.py), so no generator state is saved.

`load_params_host` stages one checkpoint's parameters in host memory without
the optimizer state (the live-weight swap's staging, serving/weights.py).
`load_pretrained_params` copies a checkpoint's weights into the leaves of
another model that share their names (a task head keeps its fresh values).

Orbax checkpoints (`format_version` 2, a `state/` directory) exist only with
JAX: reading one raises. Convert it on the JAX side with `load_params_host`
and `save_checkpoint(backend="npz")`.
"""
from __future__ import annotations

import json
import os
import struct
import time
import zipfile
import zlib
from typing import Optional

import numpy as np
import torch

from megatron_tpu_torch.config import MegatronConfig, ResilienceConfig
from megatron_tpu_torch.ops.quantized import W8
from megatron_tpu_torch.resilience import integrity
from megatron_tpu_torch.resilience.faults import fault_point
from megatron_tpu_torch.resilience.retry import RetryPolicy, policy_from, retry
from megatron_tpu_torch.training.train_step import TrainState
from megatron_tpu_torch.utils.logging import print_rank_0

TRACKER = "latest_checkpointed_iteration.txt"
STATE_DIR = "state"  # the orbax payload directory of a JAX checkpoint
PARAMS_FILE = "params.npz"
OPT_FILE = "opt_state.npz"

# seconds and bytes of the last save and load in this process, for the
# benchmarks and chip_smoke.py: {"payload_s", "manifest_s", "bytes", "dir"}
# and {"verify_s", "read_s", "dir"}
last_save: dict = {}
last_load: dict = {}


class LoadedCheckpoint:
    """load_checkpoint's result: unpacks and indexes like the
    (state, iteration, consumed_samples) 3-tuple, with `data_state` (the
    data iterator's exact-resume state, None for fresh starts), `quarantine`
    (the poison-batch windows divergence rollbacks skipped) and
    `ckpt_dir`."""

    __slots__ = ("state", "iteration", "consumed_samples", "data_state",
                 "quarantine", "ckpt_dir")

    def __init__(self, state, iteration: int, consumed_samples: int,
                 data_state: Optional[dict] = None,
                 quarantine: Optional[list] = None,
                 ckpt_dir: Optional[str] = None):
        self.state = state
        self.iteration = iteration
        self.consumed_samples = consumed_samples
        self.data_state = data_state
        self.quarantine = list(quarantine or [])
        self.ckpt_dir = ckpt_dir

    def _tuple(self):
        return (self.state, self.iteration, self.consumed_samples)

    def __iter__(self):
        return iter(self._tuple())

    def __getitem__(self, i):
        return self._tuple()[i]

    def __len__(self):
        return 3

    def __repr__(self):
        return (f"LoadedCheckpoint(iteration={self.iteration}, "
                f"consumed_samples={self.consumed_samples}, "
                f"data_state={'yes' if self.data_state else 'no'}, "
                f"quarantine={len(self.quarantine)} windows, "
                f"ckpt_dir={self.ckpt_dir!r})")


def _write_text_atomic(path: str, text: str,
                       policy: RetryPolicy = RetryPolicy()) -> None:
    """tmp + fsync + rename, retried: a torn tracker would strand every
    restart."""

    def _write():
        fault_point("checkpoint_write")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    retry(_write, policy, label=f"write:{os.path.basename(path)}")


def _publish(root: str, tag: str, d: str, resil: ResilienceConfig,
             digests: Optional[dict] = None) -> float:
    """Manifest (integrity), then tracker (visibility), then retention.
    `digests` holds the payload files' digests taken as they were written.
    Returns the manifest's seconds."""
    policy = policy_from(resil)
    t0 = time.perf_counter()
    if resil.checkpoint_integrity:
        retry(lambda: integrity.write_manifest(d, digests), policy,
              label="write_manifest")
    manifest_s = time.perf_counter() - t0
    _write_text_atomic(os.path.join(root, TRACKER), tag, policy)
    if resil.keep_last_k:
        integrity.apply_retention(root, resil.keep_last_k)
    return manifest_s


def _iter_dir(root: str, iteration: int, release: bool = False) -> str:
    return os.path.join(root, "release" if release
                        else f"iter_{iteration:07d}")


def _jax_name(name: str) -> str:
    return name.replace(".", "/")


def _param_leaves(state: TrainState) -> dict:
    return {_jax_name(k): t for k, t in state.params.state_dict().items()}


def _opt_leaves(state: TrainState) -> dict:
    """The optimizer state under JAX's flattened OptState names."""
    o = state.opt_state
    leaves = {"step": o.step}
    for group, tensors in (("mu", o.mu), ("nu", o.nu)):
        if tensors is not None:
            leaves.update({f"{group}/{_jax_name(k)}": t
                           for k, t in tensors.items()})
    leaves.update({"scaler/scale": o.scaler.scale,
                   "scaler/growth_tracker": o.scaler.growth_tracker,
                   "scaler/hysteresis": o.scaler.hysteresis})
    return leaves


def _write_npz(path: str, leaves: dict) -> tuple:
    """The file np.savez writes, filled one leaf at a time (device -> host
    -> zip member), its SHA-256 taken on another thread as each member is
    closed. Returns (bytes, (sha256, bytes) or None)."""
    with open(path, "wb") as raw:
        digest = integrity.FollowingDigest(path)
        try:
            with zipfile.ZipFile(raw, mode="w",
                                 compression=zipfile.ZIP_STORED,
                                 allowZip64=True) as zf:
                for key, t in leaves.items():
                    arr = t.detach().cpu().numpy()
                    with zf.open(key + ".npy", "w", force_zip64=True) as f:
                        np.lib.format.write_array(f, arr,
                                                  allow_pickle=False)
                    del arr
                    # the member's local header is rewritten on close:
                    # every byte before the end is final now
                    raw.flush()
                    digest.advance(raw.tell())
        except BaseException:
            digest.abandon()
            raise
    size = os.path.getsize(path)
    return size, digest.finish(size)


def save_checkpoint(root: str, state: TrainState, cfg: MegatronConfig,
                    iteration: int, consumed_samples: int = 0,
                    release: bool = False,
                    data_state: Optional[dict] = None,
                    quarantine: Optional[list] = None) -> str:
    """Write `state` as iteration `iteration` under `root` in JAX's npz
    format and publish it (manifest, tracker, retention). Every file write
    is retried. `release` writes weights only, for conversion. Returns the
    checkpoint directory."""
    resil = cfg.resilience
    policy = policy_from(resil)
    d = _iter_dir(root, iteration, release)
    os.makedirs(d, exist_ok=True)
    tag = "release" if release else str(iteration)
    save_opt = (state.opt_state is not None and not release
                and not cfg.training.no_save_optim)
    t0 = time.perf_counter()
    nbytes = 0
    digests = {}
    for fname, leaves in ((PARAMS_FILE, _param_leaves(state)),
                          (OPT_FILE, _opt_leaves(state) if save_opt
                           else None)):
        if leaves is None:
            continue
        path = os.path.join(d, fname)

        def _write(p=path, lv=leaves):
            fault_point("checkpoint_write")
            return _write_npz(p, lv)

        size, digest = retry(_write, policy, label=f"write:{fname}")
        nbytes += size
        if digest is not None:
            digests[fname] = digest
    meta = {
        "iteration": int(iteration),
        "consumed_samples": int(consumed_samples),
        "release": release,
        "has_opt_state": save_opt,
        "format_version": 1,
    }
    if data_state is not None:
        meta["data_state"] = data_state
    if quarantine:
        meta["quarantine"] = list(quarantine)
    _write_text_atomic(os.path.join(d, "metadata.json"),
                       json.dumps(meta, indent=2), policy)
    _write_text_atomic(os.path.join(d, "config.json"), cfg.to_json(), policy)
    payload_s = time.perf_counter() - t0
    manifest_s = _publish(root, tag, d, resil, digests)
    last_save.clear()
    last_save.update(dir=d, payload_s=payload_s, manifest_s=manifest_s,
                     bytes=nbytes)
    print_rank_0(f"saved checkpoint to {d} (iteration {iteration}, "
                 f"{nbytes} bytes, payload {payload_s:.2f} s, manifest "
                 f"{manifest_s:.2f} s)")
    return d


def read_tracker(root: str,
                 policy: RetryPolicy = RetryPolicy()) -> Optional[str]:
    """The tracker's tag (stripped), or None when there is no tracker."""
    p = os.path.join(root, TRACKER)
    if not os.path.exists(p):
        return None

    def _read():
        fault_point("tracker_read")
        with open(p) as f:
            return f.read().strip()

    return retry(_read, policy, label="tracker_read")


def dir_for_tag(root: str, tag: Optional[str]) -> Optional[str]:
    """Tracker tag -> checkpoint dir; None for a missing, empty or garbage
    tag (read as "no checkpoint", not a crash on int())."""
    if not tag:
        return None
    if tag == "release":
        return os.path.join(root, "release")
    try:
        return os.path.join(root, f"iter_{int(tag):07d}")
    except ValueError:
        print_rank_0(f"warning: tracker in {root} holds garbage "
                     f"({tag!r}); treating as no tracker and scanning "
                     "for the newest valid iter_* checkpoint")
        return None


def _check_npz_format(d: str) -> None:
    """Raise on a JAX orbax checkpoint, which only JAX can read."""
    if os.path.isdir(os.path.join(d, STATE_DIR)):
        raise NotImplementedError(
            f"{d} is an orbax checkpoint (format_version 2), which exists "
            "only with JAX: convert it on the JAX side with "
            "checkpointing.load_params_host + save_checkpoint(backend='npz') "
            "(orbax reads: ROADMAP Queue 1 item 2)")


def _npz_shapes(path: str) -> dict:
    """{key: shape} of an npz file, from the member headers alone."""
    shapes = {}
    with zipfile.ZipFile(path) as zf:
        for name in zf.namelist():
            with zf.open(name) as f:
                version = np.lib.format.read_magic(f)
                read = (np.lib.format.read_array_header_1_0
                        if version == (1, 0)
                        else np.lib.format.read_array_header_2_0)
                shape, _, _ = read(f)
            shapes[name[:-4] if name.endswith(".npy") else name] = shape
    return shapes


def _check_leaves(path: str, want: dict) -> None:
    """Every key of `want` ({key: shape}) present in `path` with its shape,
    and no other."""
    shapes = _npz_shapes(path)
    missing = sorted(set(want) - set(shapes))
    extra = sorted(set(shapes) - set(want))
    if missing or extra:
        raise KeyError(f"{path} does not match the model: missing "
                       f"{missing[:8]}, unexpected {extra[:8]}")
    for key, shape in want.items():
        if tuple(shapes[key]) != tuple(shape):
            raise ValueError(f"shape mismatch for {key}: ckpt "
                             f"{tuple(shapes[key])} vs model "
                             f"{tuple(shape)}")


_LOCAL_HEADER = struct.Struct("<4s2B4HL2L2H")  # a zip member's local header


def _read_exact(f, buf: memoryview) -> None:
    got = 0
    while got < len(buf):
        n = f.readinto(buf[got:])
        if not n:
            raise ValueError("npz member truncated")
        got += n


def _npz_arrays(path: str, keys=None, *, crc: bool = True):
    """Yield (key, array) for `keys` of an npz file (all its members, in
    order, when None), as np.load would give them: each stored member is
    read straight into its array, with no chunked copy. The member's CRC-32
    is checked unless `crc` is False (the caller has just verified the
    file's SHA-256 against its manifest). A missing key raises KeyError."""
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        infos = {(i.filename[:-4] if i.filename.endswith(".npy")
                  else i.filename): i for i in zf.infolist()}
        for key in (list(infos) if keys is None else keys):
            info = infos[key]
            if info.compress_type != zipfile.ZIP_STORED:
                with zf.open(info) as m:
                    yield key, np.lib.format.read_array(
                        m, allow_pickle=False)
                continue
            f.seek(info.header_offset)
            fields = _LOCAL_HEADER.unpack(f.read(_LOCAL_HEADER.size))
            if fields[0] != b"PK\x03\x04":
                raise ValueError(f"{path}: bad zip local header for {key}")
            start = info.header_offset + _LOCAL_HEADER.size + fields[-2] \
                + fields[-1]
            f.seek(start)
            version = np.lib.format.read_magic(f)
            read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                    else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read(f)
            if dtype.hasobject:
                raise ValueError(f"{path}: {key} holds Python objects")
            head = f.tell() - start
            count = int(np.prod(shape, dtype=np.int64))
            if head + count * dtype.itemsize != info.file_size:
                raise ValueError(f"{path}: {key} is not {shape} {dtype}")
            flat = np.empty(count, dtype)
            _read_exact(f, memoryview(flat.view(np.uint8)))
            if crc:
                f.seek(start)
                value = zlib.crc32(f.read(head))
                if zlib.crc32(flat.view(np.uint8), value) != info.CRC:
                    raise zipfile.BadZipFile(f"Bad CRC-32 for file "
                                             f"{info.filename!r}")
            yield key, (flat.reshape(shape[::-1]).T if fortran
                        else flat.reshape(shape))


@torch.no_grad()
def _copy_into(path: str, leaves: dict, *, crc: bool = True) -> None:
    for key, arr in _npz_arrays(path, leaves.keys(), crc=crc):
        leaves[key].copy_(torch.from_numpy(arr))


def load_checkpoint(root: str, example_state: TrainState, *,
                    finetune: bool = False, no_load_optim: bool = False,
                    resilience: Optional[ResilienceConfig] = None
                    ) -> LoadedCheckpoint:
    """Load the newest valid checkpoint under `root` into `example_state`
    (its tensors are overwritten in place and it is returned as `.state`).

    The tracker-named dir comes first, then every other `iter_*` dir newest
    first; with `resilience.checkpoint_integrity` (the default) each is
    verified against its manifest before any tensor is read and skipped
    when torn or corrupt. `finetune` loads the weights only and resets
    iteration, consumed samples and data state; `no_load_optim` keeps the
    example's optimizer state. (None, 0, 0) when nothing valid exists."""
    resil = resilience or ResilienceConfig()
    policy = policy_from(resil)
    tag = read_tracker(root, policy)
    tracked = dir_for_tag(root, tag)
    if tag is None and not integrity.list_iter_checkpoints(root):
        print_rank_0(f"no checkpoint tracker in {root}; starting from scratch")
        return LoadedCheckpoint(None, 0, 0)
    candidates = [tracked] if tracked is not None else []
    candidates += [d2 for _, d2 in integrity.list_iter_checkpoints(root)
                   if d2 not in candidates]

    for d in candidates:
        if not os.path.isdir(d):
            print_rank_0(f"warning: tracker names missing checkpoint "
                         f"{d}; falling back")
            continue
        _check_npz_format(d)
        verified = not resil.checkpoint_integrity
        digested = False  # every payload byte matched its SHA-256
        t0 = time.perf_counter()
        if resil.checkpoint_integrity:
            ok, why = integrity.verify_checkpoint(d)
            if not ok:
                print_rank_0(f"warning: checkpoint {d} failed integrity "
                             f"verification ({why}); falling back to "
                             "the previous valid checkpoint")
                continue
            verified = digested = why == "ok"
            if not verified:
                print_rank_0(f"checkpoint {d}: {why}")
        verify_s = time.perf_counter() - t0
        try:
            with open(os.path.join(d, "metadata.json")) as f:
                meta = json.load(f)
        except (OSError, ValueError) as e:
            print_rank_0(f"warning: checkpoint {d} metadata unreadable "
                         f"({e}); falling back")
            continue
        try:
            t0 = time.perf_counter()
            loaded = _restore_from_dir(d, meta, example_state,
                                       finetune=finetune,
                                       no_load_optim=no_load_optim,
                                       digested=digested)
        except Exception as e:  # noqa: BLE001 — see below
            if verified:
                # the payload checksummed clean: a real error (a tree or
                # shape mismatch, another model's config) must surface
                raise
            print_rank_0(f"warning: restore from unverified checkpoint "
                         f"{d} failed ({type(e).__name__}: {e}); "
                         "falling back")
            continue
        last_load.clear()
        last_load.update(dir=d, verify_s=verify_s,
                         read_s=time.perf_counter() - t0)
        return loaded

    print_rank_0(f"no valid checkpoint under {root}; starting from scratch")
    return LoadedCheckpoint(None, 0, 0)


def _restore_from_dir(d: str, meta: dict, example_state: TrainState, *,
                      finetune: bool = False, no_load_optim: bool = False,
                      digested: bool = False) -> LoadedCheckpoint:
    release = bool(meta.get("release", os.path.basename(d) == "release"))
    load_optim = (not finetune and not no_load_optim and not release
                  and example_state.opt_state is not None)
    params_path = os.path.join(d, PARAMS_FILE)
    opt_path = os.path.join(d, OPT_FILE)
    load_optim = load_optim and os.path.exists(opt_path)
    params = _param_leaves(example_state)
    _check_leaves(params_path, _shapes(params))
    if load_optim:
        opt = _opt_leaves(example_state)
        _check_leaves(opt_path, _shapes(opt))
    # every key and shape checked: only now is the example overwritten
    _copy_into(params_path, params, crc=not digested)
    if load_optim:
        _copy_into(opt_path, opt, crc=not digested)

    if finetune or release:
        # a fresh run: the data stream restarts too
        iteration, consumed = 0, 0
        data_state, quarantine = None, []
    else:
        iteration = int(meta["iteration"])
        consumed = int(meta.get("consumed_samples", 0))
        data_state = meta.get("data_state")
        quarantine = meta.get("quarantine", [])
    example_state.iteration = iteration
    print_rank_0(f"loaded checkpoint {d} (iteration {iteration}, "
                 f"consumed_samples {consumed}"
                 + (", exact data-resume state" if data_state else "")
                 + (f", {len(quarantine)} quarantined window(s)"
                    if quarantine else "") + ")")
    return LoadedCheckpoint(example_state, iteration, consumed,
                            data_state=data_state, quarantine=quarantine,
                            ckpt_dir=d)


def tracked_dir(root: str) -> str:
    """The directory the tracker under `root` names; raises without one."""
    d = dir_for_tag(root, read_tracker(root))
    if d is None:
        raise FileNotFoundError(f"no checkpoint tracker {TRACKER} in {root}")
    return d


def read_params(d: str, *, verified: bool = False) -> dict:
    """The flat {"a/b/c": array} parameters of one checkpoint dir
    (`verified`: its manifest was just checked, so the zip's CRC-32s are
    not)."""
    _check_npz_format(d)
    return dict(_npz_arrays(os.path.join(d, PARAMS_FILE), crc=not verified))


def _shapes(leaves: dict) -> dict:
    return {k: tuple(t.shape) for k, t in leaves.items()}


def tree_leaves(params) -> dict:
    """{"a/b/c": leaf} of a LanguageModel or a parameter tree (JAX's
    `_flatten` names); a W8 leaf (ops/quantized.py) stays one leaf."""
    tree = params.tree() if hasattr(params, "tree") else params
    out = {}

    def walk(prefix, node):
        if hasattr(node, "items"):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else k, v)
        else:
            out[prefix] = node
    walk("", tree)
    return out


def example_shapes(example_params) -> dict:
    """{"a/b/c": shape} of a LanguageModel or a parameter tree, a W8 leaf
    counting as the float weight it quantizes."""
    return {k: tuple((v.q if isinstance(v, W8) else v).shape)
            for k, v in tree_leaves(example_params).items()}


def load_params_host(ckpt_dir: str, example_params, *,
                     verified: bool = False) -> dict:
    """The parameters of one npz checkpoint dir staged in host memory
    (checkpointing.py load_params_host): {"a/b/c": numpy array} in the
    file's dtype (numpy has no bfloat16; the placement casts), every key
    and shape checked against `example_params` before any array is read.
    The optimizer state is never read and nothing touches a device. An
    orbax checkpoint raises (ROADMAP Queue 1 item 2). `verified`: the
    manifest was just checked, so the zip's CRC-32s are not."""
    _check_npz_format(ckpt_dir)
    path = os.path.join(ckpt_dir, PARAMS_FILE)
    want = example_shapes(example_params)
    _check_leaves(path, want)
    return dict(_npz_arrays(path, want, crc=not verified))


def load_config_from_checkpoint(root: str) -> Optional[MegatronConfig]:
    """The config.json of the tracker-named checkpoint, or of the newest
    iter_* dir whose config is readable (`--use_checkpoint_args`)."""
    d = dir_for_tag(root, read_tracker(root))
    candidates = ([d] if d is not None else []) + \
        [d2 for _, d2 in integrity.list_iter_checkpoints(root) if d2 != d]
    for c in candidates:
        try:
            with open(os.path.join(c, "config.json")) as f:
                return MegatronConfig.from_dict(json.load(f))
        except (OSError, ValueError):
            continue
    return None


@torch.no_grad()
def load_pretrained_params(root: str, model: torch.nn.Module, *,
                           label: str = "pretrained_checkpoint") -> list:
    """Copy the weights of the checkpoint the tracker under `root` names
    into `model`'s leaves of the same name (finetuning from a pretraining
    checkpoint: the reference's partial restore). Leaves the checkpoint
    lacks keep their values and are reported; a leaf of another shape
    raises; the checkpoint's other leaves (a pretraining head) are not
    read. The directory is verified against its manifest first. Returns
    the names kept."""
    d = tracked_dir(root)
    _check_npz_format(d)
    ok, why = integrity.verify_checkpoint(d)
    if not ok:
        raise ValueError(f"checkpoint {d} failed integrity verification "
                         f"({why})")
    path = os.path.join(d, PARAMS_FILE)
    shapes = _npz_shapes(path)
    leaves = {_jax_name(k): t for k, t in model.state_dict().items()}
    for key, t in leaves.items():
        if key in shapes and tuple(shapes[key]) != tuple(t.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt "
                             f"{tuple(shapes[key])} vs model "
                             f"{tuple(t.shape)}")
    _copy_into(path, {k: t for k, t in leaves.items() if k in shapes},
               crc=why != "ok")
    kept = sorted(k for k in leaves if k not in shapes)
    if kept:
        print_rank_0(f"{label}: kept fresh init for {len(kept)} leaves "
                     f"absent on disk: {', '.join(kept[:8])}"
                     f"{' ...' if len(kept) > 8 else ''}")
    return kept
