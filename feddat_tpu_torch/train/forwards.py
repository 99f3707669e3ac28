"""Functional calls into the model, and the ViLT and ALBEF train forwards.

Counterpart of ``feddat_tpu/train/forwards.py``.  JAX applies a module to a
parameter tree (``model.apply({"params": p}, ..., rngs={"dropout": key},
method=...)``); here :func:`call_method` runs a method of an ``nn.Module``
with its parameters replaced by a ``{state_dict name: tensor}`` dict through
``torch.func.functional_call``, so the train steps can differentiate with
respect to any partition of that dict, and with ``rng`` as the generator of
every dropout mask drawn inside.  The forwards are ``forward(params, batch,
adapter_mode, gen) -> (task_loss, logits)``, ``gen`` the stage's dropout
generator; ALBEF's momentum-distillation forward
(:func:`make_albef_distill_forward`) also takes and returns the momentum
twin, and :func:`add_alpha` is its per-batch alpha ramp.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from feddat_tpu_torch.train.losses import bce_with_logits_vqa, cross_entropy
from feddat_tpu_torch.utils.seeding import dropout_rng


class _Method(nn.Module):
    def __init__(self, model: nn.Module, method: str):
        super().__init__()
        self.model = model
        self.method = method

    def forward(self, *args, **kwargs):
        return getattr(self.model, self.method)(*args, **kwargs)


def call_method(model: nn.Module, params: Mapping[str, torch.Tensor], method: str, *args,
                rng: Optional[torch.Generator] = None, **kwargs):
    """``getattr(model, method)(*args, **kwargs)`` with the model's parameters
    taken from ``params`` (every name of ``model.state_dict()``) and ``rng``
    as the dropout generator."""
    wrapper = _Method(model, method)
    with dropout_rng(rng):
        return torch.func.functional_call(
            wrapper, {f"model.{k}": v for k, v in params.items()}, args, kwargs, strict=True)


def to_device(batch: Mapping[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy/tensor batch -> tensors on ``device`` (dtypes kept)."""
    return {k: torch.as_tensor(np.ascontiguousarray(v) if isinstance(v, np.ndarray) else v).to(device)
            for k, v in batch.items()}


def make_vilt_forward(model: nn.Module, task_key: str, loss: str = "vqa"):
    """``forward(params, batch, adapter_mode, gen) -> (task_loss, logits)``:
    BCE·C for VQA (``task_trainer.py:299``) or CE for NLVR2/SNLI-VE/VCR.
    ViLT's rates are 0, so ``gen`` feeds only the multiple-choice head's 0.1."""

    def forward(p, batch, mode, gen=None):
        _, logits = call_method(model, p, "forward", task_key, batch, adapter_mode=mode,
                                deterministic=False, rng=gen)
        if loss == "vqa":
            task_loss = bce_with_logits_vqa(logits, batch["target_scores"])
        else:
            task_loss = cross_entropy(logits, batch["labels"])
        return task_loss, logits

    return forward


def make_vilt_fused_parts(model: nn.Module, task_key: str, dropout: bool = False):
    """``(encode, head_fn, task_loss)`` for the fused DAT step, as
    ``engine.py::_build_fused_dat_step`` builds them for ViLT: the encoder
    returns pooled features (stochastic with the stage's generator when
    ``dropout``); the head runs functionally on the head partition alone (the
    other parameters are not needed)."""
    head = model.head(task_key)
    prefix = f"task_{task_key}."

    def encode(p, batch, mode, gen=None):
        return call_method(model, p, "encode_single_image", task_key, batch, adapter_mode=mode,
                           deterministic=not dropout, rng=gen)

    def head_fn(head_params, pooled):
        sub = {k[len(prefix):]: v for k, v in head_params.items()}
        return torch.func.functional_call(head, sub, (pooled,), strict=True)

    def task_loss(logits, batch):
        return bce_with_logits_vqa(logits, batch["target_scores"])

    return encode, head_fn, task_loss


def make_albef_forward(model: nn.Module, pad_token_id: int = 0):
    """ALBEF train forward -> (weighted LM loss, shifted logits), the
    no-distill branch (``albef_model.py:69-145``, ``train_albef.sh``): the
    shifted decoder logits are what DAT's mutual distillation compares
    (``task_trainer.py:300,320``).  Dropout is live, from ``gen``."""

    def forward(p, batch, mode, gen=None):
        return call_method(model, p, "forward", batch, adapter_mode=mode, deterministic=False,
                           alpha=batch.get("alpha", 0.0), pad_token_id=pad_token_id, rng=gen)

    return forward


def make_albef_distill_forward(model: nn.Module, pad_token_id: int = 0):
    """Momentum-distillation forward for the plain (single-update) step
    (``albef_model.py:100-132``): ``forward(params, batch, mode, (g1, g2),
    aux) -> (loss, logits, aux)``, ``aux`` the twin ``{state_dict name:
    tensor}``.  Without a gradient it EMA-updates the twin from ``params``
    (``models/albef.py::momentum_update_``: every tensor, frozen ones too, in
    place) and runs the twin's ``forward_train_logits`` with live dropout
    from ``g1`` (JAX's ``r1``); then the model's forward, with dropout from
    ``g2``, mixes ``(1 - alpha)·CE + alpha·soft-CE`` against the twin's
    softmax.  The twin comes back as the same tensors.  (Distillation runs on
    the plain path only: the reference's DAT + distill combination never
    activates the twins' adapters.)"""
    from feddat_tpu_torch.models.albef import momentum_update_

    def forward(p, batch, mode, gens, aux):
        g1, g2 = gens
        with torch.no_grad():
            momentum_update_({k: v.detach() for k, v in p.items()}, aux, model.cfg.momentum)
            soft = call_method(model, aux, "forward_train_logits", batch, adapter_mode=mode,
                               deterministic=False, rng=g1)
        loss, logits = call_method(model, p, "forward", batch, adapter_mode=mode, deterministic=False,
                                   soft_logits=soft, alpha=batch.get("alpha", 0.0),
                                   pad_token_id=pad_token_id, rng=g2)
        return loss, logits, aux

    return forward


def add_alpha(batch: Dict[str, Any], epoch: int, step: int, steps_per_epoch: int) -> Dict[str, Any]:
    """The distillation alpha ramp (``train_vqa_crossvqa.py:265-271``): 0.4
    ramped linearly over epoch 0, 0.4 afterwards.  A new dict with
    ``"alpha"`` as a 0-dim fp32 CPU tensor holding JAX's float32 value: a
    tensor leaf, so a compiled step reads it afresh at every replay instead
    of keying a new capture on each value; the batch's own arrays are not
    touched."""
    alpha = 0.4 if epoch > 0 else 0.4 * min(1.0, step / max(1, steps_per_epoch))
    out = dict(batch)
    out["alpha"] = torch.tensor(alpha, dtype=torch.float32)
    return out
