"""Evaluation loops (counterpart of ``feddat_tpu/train/evaluation.py``).

VQA soft score (ViLT classification) with exact example counting through
the batches' ``valid`` mask, ALBEF's rank-answer hit count, and the DAT
protocol scoring [ensemble, adapter_0 only, adapter_1 only] in one pass over
the data (``task_trainer.py:229-244``).  Per-batch scores stay on the device until
the loop ends, so the host never waits on the card between batches.  Both eval
steps are :class:`~feddat_tpu_torch.train.compiled.Compiled` functions, replayed
as CUDA graphs on the card (one per batch shape and adapter mode), as JAX jits
them (evaluation.py:41, :68).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List

import torch

from feddat_tpu_torch.data.vqa_scoring import batch_accuracy, compute_score_with_logits
from feddat_tpu_torch.models.adapters import MODE_ENSEMBLE
from feddat_tpu_torch.train.compiled import Compiled
from feddat_tpu_torch.train.forwards import call_method, to_device


def _eval_prologue(params, batch, adapter_mode="none", **extra):
    """-> the eval body's inputs: the params, the batch on their device and
    the adapter mode (a static leaf: one graph per mode)."""
    device = next(iter(params.values())).device
    inputs = {"params": params, "batch": to_device(batch, device), "mode": adapter_mode, **extra}
    return inputs, (), None


def make_eval_step(model, task_key: str, metric: str = "vqa_score") -> Compiled:
    """``step(params, batch, adapter_mode) -> masked per-batch score sum``
    (a 0-d tensor on the model's device)."""
    if metric not in ("vqa_score", "accuracy"):
        raise ValueError(metric)

    @torch.no_grad()
    def body(inp, gens):
        batch = inp["batch"]
        _, logits = call_method(model, inp["params"], "forward", task_key, batch,
                                adapter_mode=inp["mode"], deterministic=True)
        if metric == "vqa_score":
            per = compute_score_with_logits(logits, batch["target_scores"].to(torch.float32))
        else:
            per = batch_accuracy(logits, batch["labels"])
        valid = batch.get("valid")
        if valid is not None:
            per = per * valid.to(per.dtype)
        return per.sum()

    return Compiled(body, _eval_prologue, name="eval_step",
                    key=("eval_step", id(model), task_key, metric))


def make_albef_eval_step(model, answer_ids, answer_mask, k: int = 64, pad_token_id: int = 0):
    """ALBEF rank-answer eval: ``step(params, batch, adapter_mode) -> masked
    hit count`` (0-d tensor), one point where the top reranked answer is any
    ground-truth label (``gt_labels`` [B, G], -1 padded).  ``answer_ids`` /
    ``answer_mask``: the tokenised bank [num_answers, La]; ``k`` is capped by
    its size."""
    bank = (torch.as_tensor(answer_ids), torch.as_tensor(answer_mask))
    k = min(k, int(bank[0].shape[0]))
    on_device = {}

    def prologue(params, batch, adapter_mode="none"):
        device = next(iter(params.values())).device
        if device not in on_device:  # the bank moves to the card once
            on_device[device] = tuple(t.to(device) for t in bank)
        return _eval_prologue(params, batch, adapter_mode, bank=on_device[device])

    @torch.no_grad()
    def body(inp, gens):
        batch = inp["batch"]
        topk_ids, _ = call_method(model, inp["params"], "rank_answer", batch, *inp["bank"], k,
                                  inp["mode"], pad_token_id)
        gt = batch["gt_labels"]
        hit = ((topk_ids[:, :1] == gt) & (gt >= 0)).any(dim=1).to(torch.float32)
        valid = batch.get("valid")
        if valid is not None:
            hit = hit * valid.to(hit.dtype)
        return hit.sum()

    return Compiled(body, prologue, name="albef_eval_step",
                    key=("albef_eval_step", id(model), k, pad_token_id))


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
