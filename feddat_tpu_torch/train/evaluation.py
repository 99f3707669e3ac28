"""Evaluation loops (counterpart of ``feddat_tpu/train/evaluation.py``).

VQA soft score (ViLT classification) with exact example counting through
the batches' ``valid`` mask, ALBEF's rank-answer hit count, and the DAT
protocol scoring [ensemble, adapter_0 only, adapter_1 only] in one pass over
the data (``task_trainer.py:229-244``).  Per-batch scores stay on the device until
the loop ends, so the host never waits on the card between batches.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List

import torch

from feddat_tpu_torch.data.vqa_scoring import batch_accuracy, compute_score_with_logits
from feddat_tpu_torch.models.adapters import MODE_ENSEMBLE
from feddat_tpu_torch.train.forwards import call_method, to_device


def make_eval_step(model, task_key: str, metric: str = "vqa_score"):
    """``step(params, batch, adapter_mode) -> masked per-batch score sum``
    (a 0-d tensor on the model's device)."""
    if metric not in ("vqa_score", "accuracy"):
        raise ValueError(metric)

    @torch.no_grad()
    def step(params, batch, adapter_mode="none"):
        device = next(iter(params.values())).device
        batch = to_device(batch, device)
        _, logits = call_method(model, params, "forward", task_key, batch,
                                adapter_mode=adapter_mode, deterministic=True)
        if metric == "vqa_score":
            per = compute_score_with_logits(logits, batch["target_scores"].to(torch.float32))
        else:
            per = batch_accuracy(logits, batch["labels"])
        valid = batch.get("valid")
        if valid is not None:
            per = per * valid.to(per.dtype)
        return per.sum()

    return step


def make_albef_eval_step(model, answer_ids, answer_mask, k: int = 64, pad_token_id: int = 0):
    """ALBEF rank-answer eval: ``step(params, batch, adapter_mode) -> masked
    hit count`` (0-d tensor), one point where the top reranked answer is any
    ground-truth label (``gt_labels`` [B, G], -1 padded).  ``answer_ids`` /
    ``answer_mask``: the tokenised bank [num_answers, La]; ``k`` is capped by
    its size."""
    answer_ids, answer_mask = torch.as_tensor(answer_ids), torch.as_tensor(answer_mask)
    k = min(k, int(answer_ids.shape[0]))

    @torch.no_grad()
    def step(params, batch, adapter_mode="none"):
        device = next(iter(params.values())).device
        batch = to_device(batch, device)
        topk_ids, _ = call_method(model, params, "rank_answer", batch, answer_ids.to(device),
                                  answer_mask.to(device), k, adapter_mode, pad_token_id)
        gt = batch["gt_labels"]
        hit = ((topk_ids[:, :1] == gt) & (gt >= 0)).any(dim=1).to(torch.float32)
        valid = batch.get("valid")
        if valid is not None:
            hit = hit * valid.to(hit.dtype)
        return hit.sum()

    return step


def _total(partials: List[torch.Tensor]) -> float:
    return float(sum(float(p) for p in partials)) if partials else 0.0


def evaluate(params, eval_step, batches: Iterable[Dict[str, Any]], num_examples: int,
             adapter_mode: str = "none", debug_steps: int = 0) -> float:
    """Score sum over the loader / num_examples * 100 (``task_trainer.py:157``);
    ``debug_steps`` truncates like the reference's ``--debug N``."""
    partials = []
    for step_idx, batch in enumerate(batches):
        if debug_steps and step_idx > debug_steps:
            break
        partials.append(eval_step(params, batch, adapter_mode=adapter_mode))
    return _total(partials) / max(1, num_examples) * 100.0


def evaluate_dat(params, eval_step, batches_factory: Callable[[], Iterable[Dict[str, Any]]],
                 num_examples: int, debug_steps: int = 0) -> List[float]:
    """[gated ensemble, adapter_0 only, adapter_1 only], each batch scored
    under all three modes in one pass over the data."""
    modes = (MODE_ENSEMBLE, "adapter_0", "adapter_1")
    partials: Dict[str, list] = {m: [] for m in modes}
    for step_idx, batch in enumerate(batches_factory()):
        if debug_steps and step_idx > debug_steps:
            break
        for m in modes:
            partials[m].append(eval_step(params, batch, adapter_mode=m))
    return [_total(partials[m]) / max(1, num_examples) * 100.0 for m in modes]
