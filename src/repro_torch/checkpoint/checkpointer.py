"""Fault-tolerant checkpointing: atomic npz + manifest, async writes and
retention. Port of ``repro/checkpoint/checkpointer.py``, in the same
on-disk layout, so a checkpoint written by either package restores in the
other.

Layout: ``<dir>/step_<n:012d>/arrays.npz`` + ``manifest.json``; a checkpoint
counts once ``manifest.json`` exists (written last, fsync'd), so a killed
writer leaves a ``.tmp`` directory that is ignored and removed on the next
save. ``arrays.npz`` is staged under a ``.tmp`` name, fsync'd and renamed,
and its sha256 is recorded in the manifest; ``restore`` verifies the digest
(CheckpointCorruptError on a mismatch) and ``restore_latest`` skips a
corrupt newest step, with a warning, to the most recent intact one.

Tensors are saved as numpy (from any device; bfloat16 has no numpy type,
so callers widen it first, as ``store.quantized.store_to_arrays`` does);
``restore`` returns numpy leaves and the caller places them.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
import warnings
import zipfile
from typing import Any

import numpy as np
import torch


class CheckpointCorruptError(RuntimeError):
    """A checkpoint exists but fails integrity checks (bad digest,
    truncated npz, unreadable manifest)."""


def flatten_with_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """Flatten a nested dict into ``[("a/b/c", leaf), ...]``, keys sorted at
    every level: the reference's ``models/module.flatten_with_paths``."""
    out: list[tuple[str, Any]] = []
    if isinstance(tree, dict):
        for k in sorted(tree.keys()):
            out.extend(flatten_with_paths(tree[k], f"{prefix}{k}/"))
    else:
        out.append((prefix[:-1] if prefix.endswith("/") else prefix, tree))
    return out


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def _unflatten(flat: dict[str, Any]) -> Any:
    tree: dict = {}
    for path, leaf in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_write: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self._pending: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ----------------------------------------------------------- writing ---
    def save(self, step: int, tree: Any, extra: dict | None = None):
        """Write ``tree`` (nested dicts of tensors or arrays) as step
        ``step``, with ``extra`` (JSON-able) in the manifest. The arrays are
        copied to the host before this returns, also with ``async_write``."""
        flat = {p: _numpy(v) for p, v in flatten_with_paths(tree)}
        if self.async_write:
            self.wait()
            self._pending = threading.Thread(
                target=self._write, args=(step, flat, extra or {}),
                daemon=True)
            self._pending.start()
        else:
            self._write(step, flat, extra or {})

    def _write(self, step: int, flat: dict, extra: dict):
        final = os.path.join(self.dir, f"step_{step:012d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        apath = os.path.join(tmp, "arrays.npz")
        with open(apath + ".tmp", "wb") as f:     # a file handle: np.savez
            np.savez(f, **flat)                   # appends no ".npz"
            f.flush()
            os.fsync(f.fileno())
        os.rename(apath + ".tmp", apath)
        manifest = {"step": step, "time": time.time(),
                    "n_arrays": len(flat), "extra": extra,
                    "checksum": {"arrays.npz": _sha256(apath)}}
        mpath = os.path.join(tmp, "manifest.json")
        with open(mpath, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:012d}"),
                          ignore_errors=True)
        for name in os.listdir(self.dir):   # crashed writers' tmp dirs
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, name),
                              ignore_errors=True)

    # ----------------------------------------------------------- reading ---
    def all_steps(self) -> list[int]:
        out = []
        for name in sorted(os.listdir(self.dir)):
            if not name.startswith("step_") or name.endswith(".tmp"):
                continue
            if os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore_latest(self) -> tuple[int, Any, dict]:
        """Restore the newest intact checkpoint -> (step, tree, manifest).
        A corrupt newest step is skipped with a warning and the next older
        one is tried."""
        steps = self.all_steps()
        if not steps:
            raise FileNotFoundError(f"no complete checkpoint under {self.dir}")
        for step in reversed(steps):
            try:
                tree, manifest = self.restore(step)
                return step, tree, manifest
            except (CheckpointCorruptError, zipfile.BadZipFile, ValueError,
                    EOFError, OSError, json.JSONDecodeError, KeyError) as e:
                warnings.warn(
                    f"checkpoint step {step} under {self.dir} is corrupt "
                    f"({type(e).__name__}: {e}); falling back to an older "
                    f"step", stacklevel=2)
        raise FileNotFoundError(
            f"no intact checkpoint under {self.dir} "
            f"(all {len(steps)} candidate steps corrupt)")

    def verify(self, step: int) -> None:
        """Integrity-check one step without loading its arrays: raises
        CheckpointCorruptError on a digest mismatch. Checkpoints without a
        recorded digest verify trivially."""
        path = os.path.join(self.dir, f"step_{step:012d}")
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise CheckpointCorruptError(
                f"step {step}: unreadable manifest ({e})") from e
        want = (manifest.get("checksum") or {}).get("arrays.npz")
        if want is None:
            return
        apath = os.path.join(path, "arrays.npz")
        try:
            got = _sha256(apath)
        except OSError as e:
            raise CheckpointCorruptError(
                f"step {step}: unreadable arrays.npz ({e})") from e
        if got != want:
            raise CheckpointCorruptError(
                f"step {step}: arrays.npz sha256 mismatch "
                f"(manifest {want[:12]}…, file {got[:12]}…)")

    def restore(self, step: int) -> tuple[Any, dict]:
        """-> (tree of numpy arrays, manifest) of step ``step``."""
        path = os.path.join(self.dir, f"step_{step:012d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        self.verify(step)
        try:
            with np.load(os.path.join(path, "arrays.npz")) as z:
                flat = {k: z[k] for k in z.files}
        except (zipfile.BadZipFile, ValueError, EOFError, OSError) as e:
            raise CheckpointCorruptError(
                f"step {step}: arrays.npz unreadable ({e})") from e
        return _unflatten(flat), manifest
