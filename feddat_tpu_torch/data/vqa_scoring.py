"""VQA soft-score utilities (counterpart of ``feddat_tpu/data/vqa_scoring.py``;
parity with ``src/utils/vqa_utils.py`` and ``train_vqa_crossvqa.py:241-257``)."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def get_score(occurences: int) -> float:
    """Occurrence count -> VQA soft score (``vqa_utils.py:21-31``)."""
    if occurences == 0:
        return 0.0
    if occurences == 1:
        return 0.3
    if occurences == 2:
        return 0.6
    if occurences == 3:
        return 0.9
    return 1.0


def target_tensor(num_labels: int, labels: Sequence[int], scores: Sequence[float]) -> np.ndarray:
    """Scatter soft scores into a dense [num_labels] target (``vqa_utils.py:62-67``)."""
    target = np.zeros((num_labels,), dtype=np.float32)
    if len(labels):
        target[np.asarray(labels, dtype=np.int64)] = np.asarray(scores, dtype=np.float32)
    return target


def compute_score_with_logits(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-sample VQA score of the argmax answer: ``target[argmax(logits)]``."""
    pred = torch.argmax(logits, dim=-1)
    return target.gather(-1, pred[:, None])[:, 0]


def batch_accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-sample 0/1 accuracy for CE tasks (``task_trainer.py:139``)."""
    return (torch.argmax(logits, dim=-1) == labels).to(torch.float32)
