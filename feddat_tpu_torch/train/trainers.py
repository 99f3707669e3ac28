"""Trainer registry: task-trainer kind -> engine hooks, and the fused ALBEF step.

Counterpart of ``feddat_tpu/train/trainers.py``.  Each kind resolves to the
hooks the engine consumes (forward factory, eval factory); ALBEF's fused DAT
step runs one ensemble encoder + decoder-backbone pass per batch, with only
the ``cls`` LM head differing between DAT stages ① and ③.  ``albef_distill``
adds the momentum-distillation hooks: the twin's seed (``aux_init``), the
alpha ramp (``batch_transform``) and the aux-threading forward.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, Optional

import torch

from feddat_tpu_torch.configs.core import PEFTMode
from feddat_tpu_torch.peft.partition import label_params, split_by_roles
from feddat_tpu_torch.train.dat import (
    Partitioner,
    make_dat_train_step_fused,
    make_dat_train_step_joint,
)
from feddat_tpu_torch.train.evaluation import make_albef_eval_step
from feddat_tpu_torch.train.forwards import (
    add_alpha,
    call_method,
    make_albef_distill_forward,
    make_albef_forward,
    make_vilt_forward,
    make_vilt_fused_parts,
)

logger = logging.getLogger("feddat_tpu_torch")


@dataclasses.dataclass
class TrainerHooks:
    """The engine's ``make_forward``/``make_eval`` and metric for one kind,
    and ``albef_distill``'s: ``aux_init(params) -> aux`` seeds each client's
    twin, ``batch_transform(batch, epoch, step, steps_per_epoch)`` runs on
    each batch, ``aux_forward`` marks the forward as aux-threading."""

    make_forward: Callable
    make_eval: Optional[Callable] = None
    metric: str = "vqa_score"
    aux_init: Optional[Callable] = None
    batch_transform: Optional[Callable] = None
    aux_forward: bool = False


def vilt_hooks(loss: str = "vqa", metric: str = "vqa_score") -> TrainerHooks:
    return TrainerHooks(make_forward=lambda model, task_key: make_vilt_forward(model, task_key, loss),
                        metric=metric)


def albef_hooks(answer_banks: Dict[str, Any], distill: bool = False, rank_k: int = 64,
                pad_token_id: int = 0) -> TrainerHooks:
    """``answer_banks[task_key] = (answer_ids, answer_mask)``; rank-answer
    eval.  With ``distill`` the momentum-distillation forward, the twin
    seeded from the client's parameters (``albef_model.py:158-163``) and
    :func:`~feddat_tpu_torch.train.forwards.add_alpha`."""
    make = make_albef_distill_forward if distill else make_albef_forward

    def make_eval(model, task_key):
        ids, mask = answer_banks[task_key]
        return make_albef_eval_step(model, ids, mask, k=rank_k, pad_token_id=pad_token_id)

    hooks = TrainerHooks(make_forward=lambda model, task_key: make(model, pad_token_id),
                         make_eval=make_eval)
    if distill:
        # the twin starts as the client's parameters (JAX's tree_map(lambda
        # x: x)); the step's program copies them before it updates its twin
        # in place, so the parameters themselves never change
        hooks.aux_init = dict
        hooks.batch_transform = add_alpha
        hooks.aux_forward = True
    return hooks


def albef_fused_task_loss(pad_token_id: int = 0):
    """Weighted shifted CE over the dense answer bank from pre-shifted cls
    logits: logsumexp minus the target logit, never an fp32 ``[N, La−1, V]``
    log-softmax (``albef_model.py:123-145`` semantics)."""

    def task_loss(shifted_logits: torch.Tensor, batch: Dict[str, Any]) -> torch.Tensor:
        b, a, la = batch["answer_ids"].shape
        ans_ids = batch["answer_ids"].reshape(b * a, la)
        tgt = torch.where(ans_ids == pad_token_id, -100, ans_ids)[:, 1:]
        valid = tgt != -100
        safe = torch.where(valid, tgt, 0).long()
        lse = torch.logsumexp(shifted_logits.float(), dim=-1)
        tgt_logit = torch.gather(shifted_logits, -1, safe[..., None])[..., 0].float()
        seq_loss = torch.where(valid, lse - tgt_logit, 0.0).sum(-1)
        return (batch["answer_weights"].reshape(b * a) * seq_loss).sum() / b

    return task_loss


def model_dropout_rate(model) -> float:
    """The largest configured dropout rate of the model config and its nested
    BERT config (ALBEF's hidden and attention dropout 0.1; ViLT's 0)."""
    cfg = getattr(model, "cfg", None) or getattr(model, "config", None)
    rates = [float(getattr(holder, field))
             for holder in (cfg, getattr(cfg, "bert", None)) if holder is not None
             for field in ("hidden_dropout", "attention_dropout") if hasattr(holder, field)]
    return max(rates, default=0.0)


def check_fused_dropout(model, carries: bool = False) -> float:
    """The dropout report of the fused and joint DAT steps.  ``carries=True``
    (the fused step): log at INFO its one deviation under live dropout, fresh
    masks every step but DAT stages ① and ③ sharing the ensemble pass's masks
    where the reference draws three independent forwards
    (``task_trainer.py:280-330``).  ``carries=False`` (the joint step, whose
    mega-batch pass is deterministic): warn that live dropout is dropped.
    Returns the largest rate."""
    live = model_dropout_rate(model)
    if live > 0.0 and carries:
        logger.info("fused DAT step carries live dropout (rate=%.2g) with fresh masks per step; "
                    "deviation from the reference's three independent draws: DAT stages 1 and 3 "
                    "share the ensemble pass's mask (equal in distribution)", live)
    elif live > 0.0:
        logger.warning("joint DAT step drops dropout (model config has dropout=%.2g but the joint "
                       "mega-batch pass is deterministic); training semantics differ from the "
                       "standard DAT step — set dropout to 0 for exactness or use the "
                       "standard/fused step", live)
    return live


def albef_fused_parts(model, frozen_rest: Dict[str, torch.Tensor], pad_token_id: int = 0,
                      dropout: bool = False):
    """``(encode, head_fn, task_loss)`` of the fused ALBEF step.  ``encode``
    runs ``encode_train`` (stochastic with the stage's generator when
    ``dropout``); ``head_fn`` runs ``apply_cls`` on the head partition merged
    into ``frozen_rest`` (the tied word embeddings live there)."""

    def encode(p, batch, mode, gen=None):
        return call_method(model, p, "encode_train", batch, adapter_mode=mode,
                           deterministic=not dropout, rng=gen)

    def head_fn(head, hidden):
        return call_method(model, {**frozen_rest, **head}, "apply_cls", hidden)

    return encode, head_fn, albef_fused_task_loss(pad_token_id)


def make_albef_fused_dat_step(model, params: Dict[str, torch.Tensor], opt_cfg, max_steps: int,
                              pad_token_id: int = 0, part: Optional[Partitioner] = None,
                              data_group=None):
    """-> (fused ALBEF DAT step, its partitioner).  Exact against the standard
    step when dropout is off; with live dropout the masks are threaded
    through both encoder passes (:func:`check_fused_dropout`).  ``data_group``:
    the gradient mean of the SPMD engine's data axis (``train/dat.py``)."""
    live = check_fused_dropout(model, carries=True)
    if part is None:
        part = Partitioner(params, "fed", PEFTMode.DAT)
    _, frozen_rest = split_by_roles(params, label_params(params), frozenset({"head"}))
    step = make_dat_train_step_fused(*albef_fused_parts(model, frozen_rest, pad_token_id, live > 0.0),
                                     part, opt_cfg, max_steps, data_group=data_group)
    return step, part


def make_vilt_joint_dat_step(model, task_key: str, part: Partitioner, opt_cfg, max_steps: int):
    """The joint DAT step (``train/dat.py::make_dat_train_step_joint``) of a
    ViLT model, as ``scripts/perf_sweep.py`` builds JAX's: the deterministic
    encoder and the task head of :func:`make_vilt_fused_parts`, the adapter
    names, ensemble weight and scaling of the model's ``AdapterSpec``; warns
    when the model's live dropout is dropped (:func:`check_fused_dropout`)."""
    check_fused_dropout(model, carries=False)
    spec = model.config.adapter
    return make_dat_train_step_joint(*make_vilt_fused_parts(model, task_key), part, opt_cfg,
                                     max_steps, tuple(spec.names), spec.ensemble_weight,
                                     spec.scaling)


def resolve_trainer(encoder_name: str, trainer_kind: str,
                    answer_banks: Optional[Dict[str, Any]] = None, rank_k: int = 64,
                    pad_token_id: int = 0) -> TrainerHooks:
    """trainer_kind per ``TaskSpec.trainer`` (explicit keywords: a swallowed
    ``pad_token_id`` would silently mis-mask LM targets)."""
    if encoder_name.startswith("albef"):
        if answer_banks is None:
            raise ValueError("albef trainers require answer_banks")
        return albef_hooks(answer_banks, distill=encoder_name == "albef_distill", rank_k=rank_k,
                           pad_token_id=pad_token_id)
    if trainer_kind in ("vqa_cross", "vqa"):
        return vilt_hooks(loss="vqa", metric="vqa_score")
    if trainer_kind in ("nlvr2", "snli_ve", "vcr"):
        return vilt_hooks(loss="ce", metric="accuracy")
    raise KeyError(f"unknown trainer kind {trainer_kind!r}")
