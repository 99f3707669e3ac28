"""Host seeding and dropout randomness from explicit generators.

:func:`seed_everything` seeds the host-side generators (Python's ``random``
and numpy's) with the seed plus the process index, as
``feddat_tpu/utils/seeding.py:16-23`` does; torch's global generator is left
alone, since the port draws only from explicit generators.

Counterpart of the JAX package's key threading: a train step splits its
state's key into per-stage dropout keys (``feddat_tpu/train/dat.py:226-227``,
``:357-358``, ``:646``) and re-keys each with ``utils/seeding.py::dropout_key``.
Here a step derives per-stage ``torch.Generator``\\ s the same way, and the
model's dropout sites draw their masks only from the generator that
:func:`dropout_rng` makes current, never from torch's global RNG: a live rate
with no generator raises.  torch's streams differ from JAX's, so masks agree
in distribution, not bit for bit.  A recomputed region
(``ops/remat_policy.py::remat``) keeps its masks, one byte per element as
the path without remat keeps them, and its recompute reads them again: the
same masks in the forward and the recompute, on every remat policy.
"""

from __future__ import annotations

import contextlib
import random
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

_CURRENT: Optional[torch.Generator] = None
DROPOUT_RNG_IMPLS = ("threefry", "rbg")


def process_index() -> int:
    """This process's rank in the initialised ``torch.distributed`` group, else
    0 (the counterpart of ``jax.process_index()``)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def seed_everything(seed: int, per_process_offset: bool = True) -> int:
    """Seed Python's ``random`` and numpy; returns the effective seed (seed +
    process index).  torch's global generator is not seeded."""
    eff = seed + (process_index() if per_process_offset else 0)
    random.seed(eff)
    np.random.seed(eff)
    return eff


@contextlib.contextmanager
def dropout_rng(gen: Optional[torch.Generator]) -> Iterator[None]:
    """Make ``gen`` the generator of every dropout mask drawn inside the block
    (the flax ``rngs={"dropout": key}`` of one ``apply``)."""
    global _CURRENT
    prev, _CURRENT = _CURRENT, gen
    try:
        yield
    finally:
        _CURRENT = prev


def current_rng() -> Optional[torch.Generator]:
    """The generator :func:`dropout_rng` made current, or None."""
    return _CURRENT


def keep_mask(shape, keep_prob: float, device, gen: Optional[torch.Generator]) -> torch.Tensor:
    """``jax.random.bernoulli(key, keep_prob, shape)``: a bool mask drawn from
    ``gen`` on ``device`` by one random op, so that a recomputed region keeps
    the mask and not an fp32 uniform; raises without a generator."""
    if gen is None:
        raise RuntimeError("live dropout needs an explicit generator (call_method(..., rng=gen) or "
                           "seeding.dropout_rng(gen)); the global RNG is never used")
    return torch.bernoulli(torch.empty(shape, dtype=torch.bool, device=device), keep_prob,
                           generator=gen)


def split_rng(gen: torch.Generator, n: int) -> Tuple[torch.Generator, List[int]]:
    """``jax.random.split(rng, n + 1)``: -> (the next state generator, n stage
    seeds).  ``gen`` itself is not advanced, so a step is a function of its
    state: the same state gives the same masks."""
    nxt = torch.Generator(device=gen.device)
    nxt.set_state(gen.get_state())
    seeds = torch.randint(0, 2 ** 63 - 1, (n,), generator=nxt).tolist()
    return nxt, seeds


def stage_generator(seed: int, device) -> torch.Generator:
    """One stage's dropout generator on ``device`` (a CUDA tensor's masks need
    a CUDA generator)."""
    return torch.Generator(device=device).manual_seed(seed)


def check_dropout_rng(impl: str) -> None:
    """Validate ``TrainConfig.dropout_rng``.  In the JAX package "rbg" re-keys
    each stage key for the TPU's hardware bit generator
    (``feddat_tpu/utils/seeding.py:26-40``), which has no meaning on the GPU:
    both values give the same torch generators here."""
    if impl not in DROPOUT_RNG_IMPLS:
        raise ValueError(f"unknown dropout_rng {impl!r}; have {DROPOUT_RNG_IMPLS}")
