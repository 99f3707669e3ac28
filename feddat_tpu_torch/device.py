"""Device resolution for the port's entry points.

Counterpart of the JAX package's implicit ``jax.default_backend()``: there
the backend is whatever JAX initialised; here every entry point takes an
explicit ``device`` and defaults to the CUDA card.  Asking for the card on a
host without one raises — nothing silently runs on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``.  Raises ``RuntimeError`` when a CUDA device is
    asked for (explicitly or by default) and ``torch.cuda.is_available()``
    is false; pass ``device="cpu"`` to run on the CPU on purpose."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' to run "
            "the port on the CPU explicitly"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev!s}; use 'cuda' or 'cpu'")
    return dev
