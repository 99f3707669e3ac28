"""Functional calls into the model, and the ViLT train forward.

Counterpart of ``feddat_tpu/train/forwards.py``.  JAX applies a module to a
parameter tree (``model.apply({"params": p}, ..., method=...)``); here
:func:`call_method` runs a method of an ``nn.Module`` with its parameters
replaced by a ``{state_dict name: tensor}`` dict through
``torch.func.functional_call``, so the train steps can differentiate with
respect to any partition of that dict.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from feddat_tpu_torch.train.losses import bce_with_logits_vqa, cross_entropy


class _Method(nn.Module):
    def __init__(self, model: nn.Module, method: str):
        super().__init__()
        self.model = model
        self.method = method

    def forward(self, *args, **kwargs):
        return getattr(self.model, self.method)(*args, **kwargs)


def call_method(model: nn.Module, params: Mapping[str, torch.Tensor], method: str, *args, **kwargs):
    """``getattr(model, method)(*args, **kwargs)`` with the model's parameters
    taken from ``params`` (every name of ``model.state_dict()``)."""
    wrapper = _Method(model, method)
    return torch.func.functional_call(
        wrapper, {f"model.{k}": v for k, v in params.items()}, args, kwargs, strict=True)


def to_device(batch: Mapping[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy/tensor batch -> tensors on ``device`` (dtypes kept)."""
    return {k: torch.as_tensor(np.ascontiguousarray(v) if isinstance(v, np.ndarray) else v).to(device)
            for k, v in batch.items()}


def check_no_live_dropout(model: nn.Module) -> None:
    """The port's train steps run ViLT, whose dropout rates are 0; threading
    a seeded generator through live dropout masks is ROADMAP Queue 1 work."""
    cfg = getattr(model, "config", None)
    if cfg is not None and (cfg.hidden_dropout > 0.0 or cfg.attention_dropout > 0.0):
        raise NotImplementedError(
            "live dropout in the port's train steps is not ported yet (ROADMAP Queue 1, item 13, "
            "dropout); ViLT's rates are 0")


def make_vilt_forward(model: nn.Module, task_key: str, loss: str = "vqa"):
    """``forward(params, batch, adapter_mode, gen) -> (task_loss, logits)``:
    BCE·C for VQA (``task_trainer.py:299``) or CE for NLVR2/SNLI-VE/VCR.
    ``gen`` is the step's dropout generator (unused: no live dropout)."""
    check_no_live_dropout(model)

    def forward(p, batch, mode, gen=None):
        _, logits = call_method(model, p, "forward", task_key, batch, adapter_mode=mode,
                                deterministic=False)
        if loss == "vqa":
            task_loss = bce_with_logits_vqa(logits, batch["target_scores"])
        else:
            task_loss = cross_entropy(logits, batch["labels"])
        return task_loss, logits

    return forward


def make_vilt_fused_parts(model: nn.Module, task_key: str):
    """``(encode, head_fn, task_loss)`` for the fused DAT step, as
    ``engine.py::_build_fused_dat_step`` builds them for ViLT: the encoder
    returns pooled features; the head runs functionally on the head
    partition alone (the other parameters are not needed)."""
    check_no_live_dropout(model)
    head = model.head(task_key)
    prefix = f"task_{task_key}."

    def encode(p, batch, mode, gen=None):
        return call_method(model, p, "encode_single_image", task_key, batch, adapter_mode=mode,
                           deterministic=True)

    def head_fn(head_params, pooled):
        sub = {k[len(prefix):]: v for k, v in head_params.items()}
        return torch.func.functional_call(head, sub, (pooled,), strict=True)

    def task_loss(logits, batch):
        return bce_with_logits_vqa(logits, batch["target_scores"])

    return encode, head_fn, task_loss
