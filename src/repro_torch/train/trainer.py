"""Fault-tolerant training runtime. Port of ``repro/train/trainer.py``.

  - auto-resume: on construction the trainer restores the newest COMPLETE
    checkpoint (atomic manifests: a killed run never corrupts one);
  - periodic and final checkpoints, sync or async;
  - a deterministic batch order on resume: ``batch_fn`` is a pure function
    of the step, so a restored run replays the exact batch sequence
    (bit-identical state and losses);
  - a straggler watchdog: an EMA of the step's wall time; steps slower than
    ``straggler_factor`` times the EMA are counted and returned;
  - failure injection (``fail_at_step``) for crash/restart tests.

The reference jits the step with its state donated. Here the step runs
eagerly and writes the state in place (the fit round has done so since it
was ported), so the trainer holds one copy of the state. A step's time is
taken after ``torch.cuda.synchronize`` when the state lives on the card,
and its metrics come to the host in one copy.

Restored arrays go to the trainer's device, except uint8 arrays (a
``torch.Generator`` state, which must stay on the CPU) and 0-d integer
counters (the optimizers' step, the fit's round and epoch), which the port
keeps on the host.

On a mesh (``ShardedCheckpoint``) a checkpoint holds the WHOLE state: every
rank gathers it, rank 0 writes it, and the ranks meet at a barrier; a
restore gives every rank its own part. A run checkpointed on one mesh
shape therefore resumes on another (``train/elastic``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import CheckpointManager
from repro_torch.kernels import resolve_device
from repro_torch.models.module import map_with_paths


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    keep_checkpoints: int = 3
    async_checkpoint: bool = False
    log_every: int = 10
    straggler_factor: float = 3.0
    fail_at_step: Optional[int] = None   # test hook: raise mid-run


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass(frozen=True)
class ShardedCheckpoint:
    """How a mesh run's state meets its checkpoint: ``gather`` (this rank's
    state -> the whole state; a collective every rank calls), ``shard``
    (the whole state -> this rank's), ``writer`` (this rank writes) and
    ``barrier`` (every rank waits for the write)."""
    gather: Callable[[Any], Any]
    shard: Callable[[Any], Any]
    writer: bool
    barrier: Callable[[], None]


def place_restored(tree: Any, device: torch.device) -> Any:
    """A restored tree of numpy arrays -> tensors: on ``device``, but uint8
    arrays and 0-d integer counters on the host."""
    def place(_, a):
        a = np.asarray(a)
        host = a.dtype == np.uint8 or (a.ndim == 0 and a.dtype.kind in "iu")
        t = torch.as_tensor(a)
        return t if host else t.to(device)
    return map_with_paths(place, tree)


def host_metrics(metrics: dict) -> dict:
    """A step's metrics as the trainer logs them: 0-d values as floats,
    vectors of at most 64 values as lists of floats, anything larger left
    out. They come to the host in one copy."""
    keep = {}
    for k, v in metrics.items():
        t = v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(v)
        if t.ndim == 0 or (t.ndim == 1 and t.numel() <= 64):
            keep[k] = t
    if not keep:
        return {}
    dev = next(iter(keep.values())).device
    flat = torch.cat([t.reshape(-1).to(dev, torch.float64)
                      for t in keep.values()]).cpu().tolist()
    rec, at = {}, 0
    for k, t in keep.items():
        vals, at = flat[at:at + t.numel()], at + t.numel()
        rec[k] = vals[0] if t.ndim == 0 else vals
    return rec


class Trainer:
    def __init__(self, cfg: TrainerConfig, step_fn: Callable,
                 init_state: Callable[[], Any], batch_fn: Callable[[int], Any],
                 ckpt_dir: str, *, device: str | torch.device = "cuda",
                 sharded: ShardedCheckpoint | None = None):
        """step_fn(state, batch) -> (state, metrics), writing the state in
        place or returning a new one; batch_fn(step) -> batch (MUST be
        deterministic in ``step`` for an exact resume). ``device``: where
        restored arrays go (``cuda`` unless the caller asks for the CPU).
        ``sharded``: the mesh's checkpoint hooks, or None on one device."""
        self.cfg = cfg
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.device = resolve_device(device)
        self.sharded = sharded
        self.ckpt = CheckpointManager(ckpt_dir, keep=cfg.keep_checkpoints,
                                      async_write=cfg.async_checkpoint)
        self.metrics_log: list[dict] = []
        self.straggler_steps = 0
        self.save_seconds: list[float] = []

        latest = self.ckpt.latest_step()
        self.saved_step = latest
        if latest is not None:
            t0 = time.perf_counter()
            tree, _ = self.ckpt.restore(latest)
            self.state = place_restored(tree, self.device)
            if sharded is not None:
                self.state = sharded.shard(self.state)
            self._sync()
            self.restore_seconds = time.perf_counter() - t0
            self.start_step = latest + 1
            self.resumed = True
        else:
            self.state = init_state()
            self.restore_seconds = 0.0
            self.start_step = 0
            self.resumed = False

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _save(self, step: int, extra: dict | None = None):
        t0 = time.perf_counter()
        whole = self.state if self.sharded is None \
            else self.sharded.gather(self.state)
        if self.sharded is None or self.sharded.writer:
            self.ckpt.save(step, whole, extra=extra)
        if self.sharded is not None:
            self.ckpt.wait()
            self.sharded.barrier()
        self.saved_step = step
        self.save_seconds.append(time.perf_counter() - t0)

    def run(self) -> dict:
        ema = None
        for step in range(self.start_step, self.cfg.total_steps):
            if self.cfg.fail_at_step is not None \
                    and step == self.cfg.fail_at_step:
                # crash BEFORE checkpointing this step (worst case)
                raise SimulatedFailure(f"injected failure at step {step}")

            batch = self.batch_fn(step)
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, batch)
            self._sync()
            dt = time.perf_counter() - t0

            if ema is None:
                ema = dt
            elif dt > self.cfg.straggler_factor * ema:
                self.straggler_steps += 1
            ema = 0.9 * ema + 0.1 * dt if ema else dt

            rec = host_metrics(metrics)
            rec["step"] = step
            rec["step_time_s"] = dt
            self.metrics_log.append(rec)

            if (step + 1) % self.cfg.checkpoint_every == 0:
                self._save(step, extra={"metrics": rec})

        # final checkpoint
        last = self.cfg.total_steps - 1
        if last >= self.start_step and self.saved_step != last:
            self._save(last)
        self.ckpt.wait()
        return {"final_step": self.cfg.total_steps - 1,
                "resumed": self.resumed,
                "straggler_steps": self.straggler_steps,
                "metrics": self.metrics_log}
