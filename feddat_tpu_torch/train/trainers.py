"""Trainer registry: task-trainer kind -> engine hooks, and the fused ALBEF step.

Counterpart of ``feddat_tpu/train/trainers.py``.  Each kind resolves to the
hooks the engine consumes (forward factory, eval factory); ALBEF's fused DAT
step runs one ensemble encoder + decoder-backbone pass per batch, with only
the ``cls`` LM head differing between DAT stages ① and ③.  Momentum
distillation (``albef_distill``: ``aux_init``, the distill forward,
``add_alpha``) is not ported and raises (ROADMAP Queue 1, item 9).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, Optional

import torch

from feddat_tpu_torch.configs.core import PEFTMode
from feddat_tpu_torch.peft.partition import label_params, split_by_roles
from feddat_tpu_torch.train.dat import Partitioner, make_dat_train_step_fused
from feddat_tpu_torch.train.evaluation import make_albef_eval_step
from feddat_tpu_torch.train.forwards import call_method, make_albef_forward, make_vilt_forward

logger = logging.getLogger("feddat_tpu_torch")


@dataclasses.dataclass
class TrainerHooks:
    """The engine's ``make_forward``/``make_eval`` and metric for one kind.
    JAX's distillation hooks (``aux_init``, ``batch_transform``,
    ``aux_forward``) come with ``albef_distill``."""

    make_forward: Callable
    make_eval: Optional[Callable] = None
    metric: str = "vqa_score"


def vilt_hooks(loss: str = "vqa", metric: str = "vqa_score") -> TrainerHooks:
    return TrainerHooks(make_forward=lambda model, task_key: make_vilt_forward(model, task_key, loss),
                        metric=metric)


def albef_hooks(answer_banks: Dict[str, Any], distill: bool = False, rank_k: int = 64,
                pad_token_id: int = 0) -> TrainerHooks:
    """``answer_banks[task_key] = (answer_ids, answer_mask)``; rank-answer eval."""
    if distill:
        raise NotImplementedError("ALBEF momentum distillation (albef_distill: aux_init, the distill "
                                  "forward, add_alpha) is not ported yet (ROADMAP Queue 1, item 9)")

    def make_eval(model, task_key):
        ids, mask = answer_banks[task_key]
        return make_albef_eval_step(model, ids, mask, k=rank_k, pad_token_id=pad_token_id)

    return TrainerHooks(make_forward=lambda model, task_key: make_albef_forward(model, pad_token_id),
                        make_eval=make_eval)


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


def check_fused_dropout(model) -> float:
    """Log at INFO the fused step's one deviation under live dropout: fresh
    masks every step, but DAT stages ① and ③ share the ensemble pass's masks
    where the reference draws three independent forwards
    (``task_trainer.py:280-330``).  Returns the largest rate."""
    live = model_dropout_rate(model)
    if live > 0.0:
        logger.info("fused DAT step carries live dropout (rate=%.2g) with fresh masks per step; "
                    "deviation from the reference's three independent draws: DAT stages 1 and 3 "
                    "share the ensemble pass's mask (equal in distribution)", live)
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
                              pad_token_id: int = 0, part: Optional[Partitioner] = None):
    """-> (fused ALBEF DAT step, its partitioner).  Exact against the standard
    step when dropout is off; with live dropout the masks are threaded
    through both encoder passes (:func:`check_fused_dropout`)."""
    live = check_fused_dropout(model)
    if part is None:
        part = Partitioner(params, "fed", PEFTMode.DAT)
    _, frozen_rest = split_by_roles(params, label_params(params), frozenset({"head"}))
    step = make_dat_train_step_fused(*albef_fused_parts(model, frozen_rest, pad_token_id, live > 0.0),
                                     part, opt_cfg, max_steps)
    return step, part


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
