"""AdamW with the learning rate applied from outside, and the polynomial
warmup-decay schedule (counterpart of ``feddat_tpu/train/optim.py``).

* The direction is optax's ``scale_by_adam -> add_decayed_weights(mask) ->
  scale(-1)`` written out on dicts of tensors (torch AdamW's update without
  the lr).  The lr stays outside so that the DAT step's two updates per batch
  share one schedule clock, and the head's moments advance twice per batch.
* Schedules and Adam's bias corrections are computed on the host in float32,
  as JAX does, and returned as Python floats holding that float32 value.  A
  step's device body takes them as 0-dim fp32 tensors (``lr`` and
  ``bias_correction`` of :func:`apply_direction`), so that a captured CUDA
  graph reads them afresh at every replay (``train/compiled.py``).
* ``_decay_mask`` follows the reference's no-decay routing on the port's
  state_dict names: every ``bias``, plus the LayerNorm scales under the
  parents the reference's torch modules name ``LayerNorm``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from feddat_tpu_torch.configs.core import OptimizerConfig

Tensors = Dict[str, torch.Tensor]
Scalar = Union[float, torch.Tensor]


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def _schedule_value(cfg: OptimizerConfig, count, max_steps, warmup) -> float:
    count, max_steps, warmup = _f32(count), _f32(max_steps), _f32(warmup)
    one = _f32(1.0)
    warm = count / torch.maximum(one, warmup)
    remaining = torch.clamp((max_steps - count) / torch.maximum(one, max_steps - warmup), min=0.0)
    decay = _f32(cfg.lr_end) + _f32(cfg.lr - cfg.lr_end) * remaining ** _f32(cfg.power)
    lr = torch.where(count < warmup, _f32(cfg.lr) * warm, decay)
    return float(torch.where(count >= max_steps, _f32(cfg.lr_end), lr))


def polynomial_schedule(cfg: OptimizerConfig, max_steps: int) -> Callable[[int], float]:
    """``get_polynomial_decay_schedule_with_warmup`` (power=1 -> linear);
    ``schedule(k)`` is the lr of the k-th update (0-indexed)."""
    warmup = int(max_steps * cfg.warmup_ratio)
    return lambda count: _schedule_value(cfg, count, max_steps, warmup)


def polynomial_schedule_dyn(cfg: OptimizerConfig) -> Callable[[int, int], float]:
    """:func:`polynomial_schedule` with ``max_steps`` given per call."""
    return lambda count, max_steps: _schedule_value(
        cfg, count, max_steps, torch.floor(_f32(max_steps) * _f32(cfg.warmup_ratio)))


# Parents of the LayerNorm scales the reference names ``LayerNorm.weight``
# (optim.py:77-83); HF-ViLT's layernorm_before/after, the final norm and the
# head's clf_norm0 are decayed by the reference's substring match.
_TORCH_LAYERNORM_WEIGHT_PARENTS = (
    "norm",
    "attention_norm",
    "crossattention_norm",
    "output_norm",
    "transform_norm",
)


def _decay_mask(params: Tensors) -> Dict[str, bool]:
    """name -> whether weight decay applies (``task_trainer.py:496-503``)."""

    def decays(name: str) -> bool:
        parts = name.split(".")
        if parts[-1] == "bias":
            return False
        if parts[-1] == "weight" and len(parts) > 1 and parts[-2] in _TORCH_LAYERNORM_WEIGHT_PARENTS:
            return False
        return True

    return {name: decays(name) for name in params}


@dataclasses.dataclass
class AdamState:
    """optax ``ScaleByAdamState``: one step count, first and second moments."""

    count: int
    mu: Tensors
    nu: Tensors


@dataclasses.dataclass(frozen=True)
class AdamWDirection:
    """The direction part of torch AdamW: ``-(m̂/(sqrt(v̂)+eps) + wd·p)``."""

    cfg: OptimizerConfig

    def init(self, params: Tensors) -> AdamState:
        return AdamState(0, {k: torch.zeros_like(v) for k, v in params.items()},
                         {k: torch.zeros_like(v) for k, v in params.items()})

    def bias_correction(self, count: int) -> Tuple[float, float]:
        """``(1 − β1^count, 1 − β2^count)`` in float32, on the host."""
        c = self.cfg
        return float(1.0 - _f32(c.beta1) ** count), float(1.0 - _f32(c.beta2) ** count)

    def moments(self, grads: Tensors, mu: Tensors, nu: Tensors, params: Tensors,
                bias_correction: Tuple[Scalar, Scalar]) -> Tuple[Tensors, Tensors, Tensors]:
        """The device part of one update -> (updates, new mu, new nu)."""
        c = self.cfg
        bc1, bc2 = bias_correction
        mask = _decay_mask(params)
        new_mu, new_nu, updates = {}, {}, {}
        for k, g in grads.items():
            new_mu[k] = (1.0 - c.beta1) * g + c.beta1 * mu[k]
            new_nu[k] = (1.0 - c.beta2) * (g * g) + c.beta2 * nu[k]
            u = (new_mu[k] / bc1) / (torch.sqrt(new_nu[k] / bc2) + c.adam_eps)
            if mask[k]:
                u = u + c.weight_decay * params[k]
            updates[k] = -u
        return updates, new_mu, new_nu

    def update(self, grads: Tensors, state: AdamState, params: Tensors,
               bias_correction: Optional[Tuple[Scalar, Scalar]] = None
               ) -> Tuple[Tensors, AdamState]:
        """One update; ``bias_correction`` (two floats or 0-dim fp32 tensors)
        defaults to :meth:`bias_correction` of the new count."""
        count = state.count + 1
        bc = self.bias_correction(count) if bias_correction is None else bias_correction
        updates, mu, nu = self.moments(grads, state.mu, state.nu, params, bc)
        return updates, AdamState(count, mu, nu)


def adamw_direction(cfg: OptimizerConfig) -> AdamWDirection:
    return AdamWDirection(cfg)


def apply_direction(tx: AdamWDirection, grads: Tensors, opt_state: AdamState, params: Tensors,
                    lr: Scalar, bias_correction: Optional[Tuple[Scalar, Scalar]] = None
                    ) -> Tuple[Tensors, AdamState]:
    """One torch-AdamW step at learning rate ``lr`` -> (new params, new state).
    ``lr`` and ``bias_correction`` may be 0-dim fp32 tensors on the params'
    device (the same float32 values give the same bits)."""
    updates, new_state = tx.update(grads, opt_state, params, bias_correction)
    return {k: params[k] + updates[k] * lr for k in params}, new_state
