"""FitState — everything a train / re-partition round changes.
Port of ``repro/fit/state.py``.

The scorer params, the optimizer state, the [R, L] partition, the fit's
random stream and the round / epoch counters. The reference's state is an
immutable pytree that jit donates; here a round updates the tensors in
place where that saves memory (``fit/engine.make_fit_round``). ``rng`` is
the byte state of the fit's CPU ``torch.Generator`` (``get_state()``): the
reference's JAX key cannot be reproduced by it.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass
class FitState:
    params: Any            # stacked R-rep scorer params (leading axis R)
    opt_state: Any         # optimizer state (m/v mirror params, step)
    assign: torch.Tensor   # [R, L] int32 current partition
    rng: torch.Tensor      # torch.Generator state — advanced once a round
    round_idx: int         # rounds completed
    epoch_idx: int         # total epochs completed

    def as_dict(self) -> dict:
        """Nested-dict view (the reference's checkpoint layout)."""
        return {"params": self.params, "opt": self.opt_state,
                "assign": self.assign, "rng": self.rng,
                "round": self.round_idx, "epoch": self.epoch_idx}

    @classmethod
    def from_dict(cls, d: dict) -> "FitState":
        """Inverse of :meth:`as_dict`."""
        return cls(params=d["params"], opt_state=d["opt"],
                   assign=d["assign"], rng=d["rng"],
                   round_idx=int(d["round"]), epoch_idx=int(d["epoch"]))

    @classmethod
    def create(cls, params, opt_state, assign, rng) -> "FitState":
        """``rng``: a ``torch.Generator``, its state, or an int seed."""
        if isinstance(rng, int):
            rng = torch.Generator().manual_seed(rng)
        if isinstance(rng, torch.Generator):
            rng = rng.get_state()
        return cls(params=params, opt_state=opt_state,
                   assign=torch.as_tensor(assign).to(torch.int32),
                   rng=rng, round_idx=0, epoch_idx=0)

    def generator(self) -> torch.Generator:
        """A CPU generator at this state's ``rng``."""
        gen = torch.Generator()
        gen.set_state(self.rng)
        return gen
