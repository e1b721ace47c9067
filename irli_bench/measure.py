"""Small pieces every traffic generator uses: the device's fence and peak
memory, the run's sub-seeded sample of answers to check, a tail by nearest
rank."""
from __future__ import annotations

import math
import random
import time

import torch

from irli_bench.data import subseed


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    """The most bytes the process's allocator held on the card."""
    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def release(device) -> None:
    """Return freed blocks to the card, for the reference that follows."""
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


class Phases:
    """The set-up's split: ``mark(name)`` after each phase (the card
    fenced first) -> ``split()``, the seconds of each since the last."""

    def __init__(self, started: float, device):
        self.device = device
        self.marks = [("", started)]

    def mark(self, name: str) -> float:
        sync(self.device)
        self.marks.append((name, time.perf_counter()))
        return self.marks[-1][1]

    def split(self) -> dict:
        return {name: t - self.marks[i][1]
                for i, (name, t) in enumerate(self.marks[1:])}


def nearest_rank(values, q: float) -> float:
    """The q-quantile of ``values`` by nearest rank (the smallest value with
    at least q of them at or below it); inf counts as the largest."""
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def sample(seed: int, stream: str, population: int, n: int) -> list:
    """``n`` distinct indices of ``range(population)`` drawn from the run's
    seed, sorted; every index when n >= population."""
    if n >= population:
        return list(range(population))
    return sorted(random.Random(subseed(seed, stream)).sample(
        range(population), n))
