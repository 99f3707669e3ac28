"""FedAvg aggregation (counterpart of ``feddat_tpu/federated/fedavg.py``).

Sample-count-weighted average of the communicated subset across clients
(reference ``src/train/main.py:50-65``; uniform weights at ``main.py:455``),
accumulated in fp32 in client order and cast back to each leaf's dtype.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch


def fedavg(comm_trees: Sequence[Dict[str, torch.Tensor]],
           weights: Optional[Sequence[float]] = None) -> Dict[str, torch.Tensor]:
    """Weighted average of per-client ``{name: tensor}`` dicts."""
    n = len(comm_trees)
    if weights is None:
        weights = [1.0] * n
    if len(weights) != n:
        raise ValueError(f"client_weights has {len(weights)} entries for {n} clients")
    total = float(sum(float(w) for w in weights))
    norm = [float(w) / total for w in weights]
    out = {}
    for k, first in comm_trees[0].items():
        acc = norm[0] * first.to(torch.float32)
        for w, tree in zip(norm[1:], comm_trees[1:]):
            acc = acc + w * tree[k].to(torch.float32)
        out[k] = acc.to(first.dtype)
    return out
