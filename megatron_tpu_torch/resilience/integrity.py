"""Checkpoint integrity: content manifests, verification, fallback,
retention.

A copy of megatron_tpu/resilience/integrity.py (plain Python); the port keeps its
own so that it never imports the JAX package.

A week-long run's only durable asset is its checkpoint chain, and the
reference trusts it blindly: `latest_checkpointed_iteration.txt` names
a directory and `torch.load` discovers corruption (torn write, bit
rot, a half-deleted dir) only by crashing at restore time
(ref: megatron/checkpointing.py:170-174, :476-677) — on a preemptible
cluster that turns one bad checkpoint into a dead run. Here every save
writes a `manifest.json` of per-file sizes + SHA-256 digests as the
LAST step before the tracker is published, so:

- a checkpoint without a complete, matching manifest is detectably
  torn/corrupt *before* any tensor is read;
- `load_checkpoint` verifies the tracker-named dir and falls back to
  the newest checkpoint that passes (training/checkpointing.py);
- retention (`keep_last_k`) prunes old `iter_*` dirs but NEVER deletes
  the newest verified-valid checkpoint — a corrupt tip must not leave
  the run with nothing to roll back to.

Checkpoints predating this subsystem carry no manifest; they verify as
valid-with-warning (`unverified`) so legacy dirs keep loading.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

MANIFEST = "manifest.json"
_ITER_RE = re.compile(r"^iter_(\d{7,})$")
_CHUNK = 1 << 20  # 1 MiB digest read chunks


def _digest_file(path: str) -> Tuple[str, int]:
    h = hashlib.sha256()
    size = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_CHUNK)
            if not chunk:
                break
            h.update(chunk)
            size += len(chunk)
    return h.hexdigest(), size


def _digest_files(paths: List[str]) -> List[Tuple[str, int]]:
    """_digest_file of each path, one thread a file (hashlib and file reads
    release the GIL, so a params file and an optimizer file digest side by
    side)."""
    if len(paths) < 2:
        return [_digest_file(p) for p in paths]
    with ThreadPoolExecutor(max_workers=min(len(paths), 8)) as pool:
        return list(pool.map(_digest_file, paths))


class FollowingDigest:
    """SHA-256 of a file while it is being written, on a thread of its own:
    the writer calls `advance(offset)` once every byte before `offset` is
    final (a zip member closed, its local header rewritten), and the thread
    reads the file back up to there and digests it. `finish(size)` marks the
    file complete and returns (hexdigest, size), or None if reading back
    failed (the manifest then digests the file itself). Digesting overlaps
    the write instead of following it."""

    def __init__(self, path: str):
        self._path = path
        self._final = 0
        self._done = False
        self._cv = threading.Condition()
        self._result: Optional[Tuple[str, int]] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="checkpoint-digest")
        self._thread.start()

    def advance(self, offset: int, done: bool = False) -> None:
        with self._cv:
            self._final = max(self._final, offset)
            self._done = self._done or done
            self._cv.notify()

    def finish(self, size: int) -> Optional[Tuple[str, int]]:
        self.advance(size, done=True)
        self._thread.join()
        result = self._result
        return result if result is not None and result[1] == size else None

    def abandon(self) -> None:
        self.advance(0, done=True)
        self._thread.join()

    def _run(self) -> None:
        h = hashlib.sha256()
        pos = 0
        try:
            # unbuffered: a buffered reader would read ahead past `final`
            # into bytes the writer has yet to rewrite
            with open(self._path, "rb", buffering=0) as f:
                while True:
                    with self._cv:
                        while pos >= self._final and not self._done:
                            self._cv.wait()
                        final, done = self._final, self._done
                    while pos < final:
                        chunk = f.read(min(_CHUNK * 8, final - pos))
                        if not chunk:
                            return
                        h.update(chunk)
                        pos += len(chunk)
                    if done:
                        break
        except OSError:
            return
        self._result = (h.hexdigest(), pos)


def _walk_files(ckpt_dir: str) -> List[str]:
    """All file paths under `ckpt_dir` relative to it, manifest
    excluded, sorted for a deterministic manifest."""
    out = []
    for root, _, files in os.walk(ckpt_dir):
        for fn in files:
            rel = os.path.relpath(os.path.join(root, fn), ckpt_dir)
            if rel == MANIFEST:
                continue
            out.append(rel)
    return sorted(out)


def write_manifest(ckpt_dir: str, known: Optional[
        Dict[str, Tuple[str, int]]] = None) -> str:
    """Digest every file under the checkpoint dir and write
    `manifest.json` atomically (tmp + rename: a crash mid-manifest
    leaves no half-manifest to misverify). Must be called only after
    all payload writes are durable — the save path orders it after the
    backend write and before the tracker publish. `known` holds
    {relative path: (sha256, size)} digested as the save wrote them
    (FollowingDigest); such a file whose size on disk still matches is not
    read again."""
    known = known or {}
    rels = _walk_files(ckpt_dir)
    todo = [rel for rel in rels if rel not in known or os.path.getsize(
        os.path.join(ckpt_dir, rel)) != known[rel][1]]
    digests = dict(zip(todo, _digest_files(
        [os.path.join(ckpt_dir, rel) for rel in todo])))
    entries = {}
    for rel in rels:
        digest, size = digests[rel] if rel in digests else known[rel]
        entries[rel] = {"sha256": digest, "size": size}
    doc = {"version": 1, "algorithm": "sha256", "files": entries}
    path = os.path.join(ckpt_dir, MANIFEST)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def verify_checkpoint(ckpt_dir: str, *, deep: bool = True
                      ) -> Tuple[bool, str]:
    """Return (valid, reason).

    Invalid when: the dir or its `metadata.json` is missing/unreadable
    (torn), a manifest entry's file is missing or its size differs, or
    (`deep=True`, the default) its SHA-256 digest differs (bit rot).
    A dir with metadata but no manifest is valid-with-warning
    (`'unverified (no manifest)'`) for pre-manifest checkpoints."""
    if not os.path.isdir(ckpt_dir):
        return False, "not a directory"
    meta_path = os.path.join(ckpt_dir, "metadata.json")
    try:
        with open(meta_path) as f:
            json.load(f)
    except (OSError, ValueError) as e:
        return False, f"metadata.json unreadable ({e})"
    man_path = os.path.join(ckpt_dir, MANIFEST)
    if not os.path.exists(man_path):
        return True, "unverified (no manifest)"
    try:
        with open(man_path) as f:
            doc = json.load(f)
        files = doc["files"]
    except (OSError, ValueError, KeyError) as e:
        return False, f"manifest unreadable ({e})"
    # the files in the manifest's order, the first fault reported: sizes
    # first, then the digests of the files before the first bad size, side
    # by side
    sound, fault = [], None
    for rel, want in files.items():
        p = os.path.join(ckpt_dir, rel)
        if not os.path.exists(p):
            fault = f"missing file {rel}"
            break
        size = os.path.getsize(p)
        if size != want["size"]:
            fault = f"size mismatch for {rel}: {size} != {want['size']}"
            break
        sound.append(rel)
    if deep:
        digests = _digest_files([os.path.join(ckpt_dir, rel)
                                 for rel in sound])
        for rel, (digest, _) in zip(sound, digests):
            if digest != files[rel]["sha256"]:
                return False, f"checksum mismatch for {rel}"
    if fault is not None:
        return False, fault
    return True, "ok"


def list_iter_checkpoints(root: str) -> List[Tuple[int, str]]:
    """(iteration, dir) for every `iter_*` dir under root, newest
    first. Unparseable names are ignored."""
    out = []
    try:
        names = os.listdir(root)
    except OSError:
        return []
    for name in names:
        m = _ITER_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(root, name)))
    out.sort(reverse=True)
    return out


def find_latest_valid(root: str, *, exclude: Tuple[str, ...] = (),
                      deep: bool = True) -> Optional[Tuple[int, str]]:
    """Newest `iter_*` checkpoint that verifies, skipping `exclude`
    dirs (typically the one that just failed)."""
    excl = {os.path.abspath(e) for e in exclude}
    for it, d in list_iter_checkpoints(root):
        if os.path.abspath(d) in excl:
            continue
        ok, _ = verify_checkpoint(d, deep=deep)
        if ok:
            return it, d
    return None


def apply_retention(root: str, keep_last_k: Optional[int]) -> List[str]:
    """Delete `iter_*` dirs beyond the newest `keep_last_k`, returning
    the deleted paths. Never touches `release`; never deletes the
    newest checkpoint that actually VERIFIES — if every kept dir is
    corrupt, the newest valid one survives regardless of age (deleting
    it would leave divergence rollback with nothing to restore)."""
    if not keep_last_k or keep_last_k < 1:
        return []
    ckpts = list_iter_checkpoints(root)
    if len(ckpts) <= keep_last_k:
        return []
    keep = {d for _, d in ckpts[:keep_last_k]}
    if not any(verify_checkpoint(d, deep=False)[0] for d in keep):
        newest_valid = find_latest_valid(root, deep=False)
        if newest_valid is not None:
            keep.add(newest_valid[1])
    deleted = []
    from megatron_tpu_torch.utils.logging import print_rank_0
    for _, d in ckpts[keep_last_k:]:
        if d in keep:
            continue
        shutil.rmtree(d, ignore_errors=True)
        deleted.append(d)
    if deleted:
        print_rank_0(f"retention: pruned {len(deleted)} checkpoint(s) "
                     f"beyond keep_last_k={keep_last_k}")
    return deleted
