"""Bottleneck adapter cell — the heart of DAT.

Counterpart of ``feddat_tpu/models/adapters.py::AdapterCell``.  The active
adapter is an argument of :meth:`AdapterCell.delta`, not module state.
Modes:

* ``"none"``      — zero delta;
* ``"<name>"``    — one adapter: ``up(relu(down(z)))``;
* ``"ensemble"``  — fixed ``w``/``1−w`` mix of the two members of
  :func:`ensemble_members`, times ``spec.scaling``; routed through the fused
  CUDA epilogue (``ops/adapter_fused.py``) when ``spec.fused`` is set and the
  hidden states are on the card (the JAX package tests for a TPU backend at
  adapters.py:141 instead);
* ``"weighted"``  — per-example blend, ``weights_bx [B, len(names)]``;
* ``"init_all"``  — mean of all adapters.

Parameters exist for every name whatever the mode: ``<name>_down``
(d -> d/r) and ``<name>_up`` (d/r -> d), normal(0.02) kernels, zero biases.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from feddat_tpu_torch.configs.core import AdapterSpec
from feddat_tpu_torch.ops.remat_policy import checkpoint_name

MODE_NONE = "none"
MODE_ENSEMBLE = "ensemble"
MODE_WEIGHTED = "weighted"
MODE_INIT = "init_all"


def ensemble_members(names: Sequence[str]) -> tuple:
    """Which two adapters the ensemble mixes (reference ``adapter.py:133-162``)."""
    if "adapter_2" in names:
        return ("adapter_0", "adapter_2")
    return ("adapter_0", "adapter_1")


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype,
          tag: Optional[str] = None) -> torch.Tensor:
    """flax ``nn.Dense(dtype=...)`` semantics: input, kernel and bias are
    cast to ``dtype`` and the product is returned in ``dtype``.  ``tag``
    names the product for the remat policies (``ops/remat_policy.py``); the
    casts stay outside the tag."""
    b = None if layer.bias is None else layer.bias.to(dtype)
    x, w = x.to(dtype), layer.weight.to(dtype)
    with checkpoint_name(tag):
        return nn.functional.linear(x, w, b)


class AdapterCell(nn.Module):
    """All named adapters at one insertion site."""

    def __init__(self, spec: AdapterSpec, model_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.spec = spec
        self.model_dim = model_dim
        self.dtype = dtype
        self.bottleneck = model_dim // spec.reduction_factor
        for name in spec.names:
            self.add_module(f"{name}_down", nn.Linear(model_dim, self.bottleneck))
            self.add_module(f"{name}_up", nn.Linear(self.bottleneck, model_dim))

    def _one(self, z: torch.Tensor, name: str) -> torch.Tensor:
        down = dense(z, getattr(self, f"{name}_down"), self.dtype)
        return dense(torch.relu(down), getattr(self, f"{name}_up"), self.dtype)

    def _flax_params(self, name: str):
        """(w_down [d, r], b_down, w_up [r, d], b_up) in the working dtype."""
        down, up = getattr(self, f"{name}_down"), getattr(self, f"{name}_up")
        return tuple(
            t.to(self.dtype).contiguous()
            for t in (down.weight.t(), down.bias, up.weight.t(), up.bias)
        )

    def delta(self, z: torch.Tensor, mode: str,
              weights_bx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The additive adapter update for hidden states ``z``."""
        if mode == MODE_NONE or not self.spec.enabled:
            return torch.zeros_like(z)
        if mode == MODE_INIT:
            return sum(self._one(z, n) for n in self.spec.names) / len(self.spec.names)
        if mode == MODE_WEIGHTED:
            if weights_bx is None:
                raise ValueError("adapter mode 'weighted' needs per-example adapter weights")
            out = torch.zeros_like(z)
            for i, name in enumerate(self.spec.names):
                w = weights_bx[:, i].to(z.dtype)
                w = w.reshape(w.shape + (1,) * (z.dim() - 1))
                out = out + w * self._one(z, name)
            return out * self.spec.scaling
        if mode == MODE_ENSEMBLE:
            a, b = ensemble_members(self.spec.names)
            w = self.spec.ensemble_weight
            if self.spec.fused and z.is_cuda:
                from feddat_tpu_torch.ops.adapter_fused import fused_ensemble_adapter

                delta = fused_ensemble_adapter(
                    z.to(self.dtype).contiguous(), self._flax_params(a), self._flax_params(b), w
                )
                return delta * self.spec.scaling
            return (w * self._one(z, a) + (1.0 - w) * self._one(z, b)) * self.spec.scaling
        if mode not in self.spec.names:
            raise ValueError(
                f"Unknown adapter mode {mode!r}; have {tuple(self.spec.names)} + "
                f"('{MODE_NONE}', '{MODE_ENSEMBLE}')"
            )
        return self._one(z, mode)
