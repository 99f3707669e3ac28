"""Train state (counterpart of ``feddat_tpu/train/state.py``).

JAX threads an immutable pytree through jitted steps; here the state is a
dataclass of plain dicts of tensors that each step replaces (the adapter and
head partitions are small, so the copies cost nothing next to the encoder).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch


@dataclasses.dataclass
class TrainState:
    """One client's local-training state.

    ``params`` maps state_dict names to tensors (the whole model);
    ``opt_states`` is keyed by partition ("shared", "local", "head" for DAT;
    "trainable" for the single-update modes); ``sched_count`` ticks once per
    optimizer update (twice per batch under DAT); ``rng`` seeds the step's
    dropout (unused by ViLT, whose dropout rates are 0).  The JAX state's
    ``aux`` (ALBEF's momentum twins) comes with the ALBEF slice."""

    params: Dict[str, torch.Tensor]
    opt_states: Dict[str, Any]
    sched_count: int
    rng: torch.Generator

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)
