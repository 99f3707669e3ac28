"""Train state (counterpart of ``feddat_tpu/train/state.py``).

JAX threads an immutable pytree through jitted steps; here the state is a
dataclass of plain dicts of tensors that each step replaces (the adapter and
head partitions are small, so the copies cost nothing next to the encoder).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch


@dataclasses.dataclass
class TrainState:
    """One client's local-training state.

    ``params`` maps state_dict names to tensors (the whole model);
    ``opt_states`` is keyed by partition ("shared", "local", "head" for DAT;
    "trainable" for the single-update modes); ``sched_count`` ticks once per
    optimizer update (twice per batch under DAT); ``rng`` is the generator
    each step draws its per-stage dropout seeds from (``train/dat.py``);
    ``aux`` is the auxiliary model state a step threads through, ALBEF's
    momentum twin for distillation (``{state_dict name: tensor}``), or None."""

    params: Dict[str, torch.Tensor]
    opt_states: Dict[str, Any]
    sched_count: int
    rng: torch.Generator
    aux: Optional[Dict[str, torch.Tensor]] = None

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)
