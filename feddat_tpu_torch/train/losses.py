"""Training losses (copy of ``feddat_tpu/train/losses.py`` in PyTorch).

* VQA classification loss: ``BCEWithLogitsLoss(reduction='mean') * num_labels``
  (reference ``task_trainer.py:299``), in the stable elementwise form.
* Cross-entropy for NLVR2/SNLI-VE/VCR.
* Mutual-KD loss: temperature-3 KL with ``T**2`` scaling and batchmean
  reduction (reference ``task_trainer.py:506-515``).

All compute in fp32 whatever the logits' dtype.
"""

from __future__ import annotations

import torch


def bce_with_logits_vqa(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``mean(max(x, 0) − x·t + log(1 + exp(−|x|))) · num_labels``."""
    x = logits.to(torch.float32)
    t = target.to(torch.float32)
    per_elem = torch.clamp(x, min=0.0) - x * t + torch.log1p(torch.exp(-x.abs()))
    return per_elem.mean() * logits.shape[-1]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over the batch (integer labels)."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0].mean()


def kd_kl_loss(output_logits: torch.Tensor, target_logits: torch.Tensor,
               temp: float = 3.0) -> torch.Tensor:
    """KL(softmax(target/T) ‖ softmax(output/T)) · T², summed and divided by
    the first-axis size.  The caller detaches ``target_logits``."""
    p_log = torch.log_softmax(output_logits.to(torch.float32) / temp, dim=-1)
    q = torch.softmax(target_logits.to(torch.float32) / temp, dim=-1)
    q_log = torch.where(q > 0, torch.log(torch.clamp(q, min=1e-38)), torch.zeros_like(q))
    kl = (q * (q_log - p_log)).sum() / output_logits.shape[0]
    return kl * (temp ** 2)
