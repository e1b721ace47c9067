"""Batching, placement on a mesh and prefetch. Port of
``repro/data/loader.py``.

- ``ShardedLoader`` wraps a host generator of whole global batches and
  gives each rank its block of every numpy leaf as a DTensor placed by a
  per-leaf spec on the mesh (``models/module.place``), on the mesh's
  device; other leaves pass through.
- ``Prefetcher`` runs the generator in a background thread with a bounded
  queue: if the step loop outruns the loader, the queue depth (``depth``,
  read each step) shows data-side stalls. A loader's exception reaches the
  consumer at the next ``next()``, and the end of a finite source ends
  the iteration (the reference's consumer waits forever there).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch.models.module import Spec, place


#: the end of the source (the reference's consumer waits forever there)
_END = object()


class Prefetcher:
    def __init__(self, it: Iterator, depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.it = it
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            for item in self.it:
                if self._stop.is_set():
                    return
                self.q.put(item)
            self.q.put(_END)
        except Exception as e:  # surface loader crashes to the consumer
            self.q.put(e)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is _END:
            self.q.put(_END)            # every later next() stops too
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item

    @property
    def depth(self) -> int:
        """Batches waiting in the queue."""
        return self.q.qsize()

    def close(self):
        """Stop the producer after the batch it is putting (if any)."""
        self._stop.set()


def mesh_device(mesh) -> torch.device:
    """The device of this rank's tensors on ``mesh``: the current CUDA
    device for a "cuda" mesh, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class ShardedLoader:
    """Host batches -> this rank's DTensors, a spec a leaf:
    ``spec_fn(name)`` (a cell's ``in_specs(mesh)[name]``)."""

    def __init__(self, it: Iterator[dict], mesh,
                 spec_fn: Callable[[str], Spec], prefetch: int = 2):
        self.it = Prefetcher(it, prefetch) if prefetch else it
        self.mesh = mesh
        self.spec_fn = spec_fn
        self.device = mesh_device(mesh)

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self.it)
        out = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray):
                t = torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                out[k] = place(t, self.spec_fn(k), self.mesh)
            else:
                out[k] = v
        return out
