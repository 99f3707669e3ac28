"""Checkpoint / resume (counterpart of ``feddat_tpu/utils/checkpointing.py``).

One file per round, ``<dir>/round_NNNNN``, written by ``torch.save``: the
round counter, the server parameters, every client's personal partition and
the engine generator's state (``torch.Generator.get_state()``), where the JAX
package saves a ``PRNGKey`` with orbax.  The two packages' checkpoints are not
interchangeable.  ``meta.json`` (the run's model recipe) is the same file in
both.

A round is written to a temporary name and then renamed over
``round_NNNNN`` (``os.replace``), so a process killed mid-save leaves the
previous round whole, as orbax's ``force=True`` save does.  Each tensor is
saved with a storage of its own: the live engine aliases tensors (a client's
personal store starts as the server's tensors; ALBEF's teacher is its
student at the start), and a restore must not alias where the live run did
not, nor the reverse.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import torch

from feddat_tpu_torch.device import DeviceLike, resolve_device


def _round_path(directory: str, round_idx: int) -> str:
    return os.path.join(os.path.abspath(directory), f"round_{round_idx:05d}")


def _own_storage(tree):
    """Every tensor of a nested dict copied to the host into a storage of its
    own."""
    if isinstance(tree, dict):
        return {k: _own_storage(v) for k, v in tree.items()}
    return tree.detach().to("cpu", copy=True)


def save_federated_state(directory: str, round_idx: int, server_params: Dict[str, torch.Tensor],
                         personal: Dict[str, Dict[str, torch.Tensor]],
                         rng: torch.Generator) -> str:
    """Write a round checkpoint; returns its path."""
    os.makedirs(directory, exist_ok=True)
    path = _round_path(directory, round_idx)
    state = {
        "round": int(round_idx),
        "server_params": _own_storage(server_params),
        "personal": _own_storage(personal),
        "rng": rng.get_state(),
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def write_meta(directory: str, meta: Dict[str, Any]) -> str:
    """Persist the run's model recipe next to the round checkpoints
    (``meta.json``, the keys of ``feddat_tpu/cli.py:632-652``): what
    ``serving.*.from_checkpoint`` needs to rebuild the model and choose the
    head and adapter mode."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(os.path.abspath(directory), "meta.json")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=2)
    os.replace(tmp, path)
    return path


def load_meta(directory: str) -> Optional[Dict[str, Any]]:
    path = os.path.join(os.path.abspath(directory), "meta.json")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


def latest_round(directory: str) -> Optional[int]:
    """Largest N with a ``round_NNNNN`` entry.  Strict name match: a stray
    ``round_00012_old`` or a save's temporary name never matches."""
    if not os.path.isdir(directory):
        return None
    rounds = [int(m.group(1)) for d in os.listdir(directory)
              if (m := re.fullmatch(r"round_(\d{5})", d))]
    return max(rounds) if rounds else None


def restore_federated_state(directory: str, round_idx: Optional[int] = None,
                            device: DeviceLike = None
                            ) -> Optional[Tuple[int, Dict[str, torch.Tensor],
                                                Dict[str, Dict[str, torch.Tensor]], torch.Generator]]:
    """-> (round, server_params, personal, rng) with the tensors on ``device``
    (default CUDA) and ``rng`` a CPU generator in the saved state, or None
    when there is no checkpoint."""
    device = resolve_device(device)
    if round_idx is None:
        round_idx = latest_round(directory)
        if round_idx is None:
            return None
    state = torch.load(_round_path(directory, round_idx), map_location=device,
                       weights_only=True)
    rng = torch.Generator()
    rng.set_state(state["rng"].cpu())
    return int(state["round"]), state["server_params"], state["personal"], rng
