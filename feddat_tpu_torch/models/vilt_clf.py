"""Vision-only and text-only ViLT classifiers (counterpart of
``feddat_tpu/models/vilt_clf.py``).

The reference's single-modality classification on top of the multimodal ViLT
encoder (``src/modeling/vilt_clf.py:26-127``): text-only tasks feed the mean
COCO image as a constant visual stream (its ``coco_mean_image.png``, made by
``get_avg_images.py``); vision-only tasks feed a fixed text stream of
``[CLS] [SEP]``.  Each model is the encoder ``vilt`` and the head
``task_clf``, the JAX trees' names, so ``utils/param_bridge.py::
vilt_from_flax`` carries JAX weights over.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from feddat_tpu_torch.configs.core import ViltModelConfig
from feddat_tpu_torch.models.vilt import ClassificationHead, MultiChoiceHead, ViltEncoder


def mean_image(images: np.ndarray) -> np.ndarray:
    """The offline mean image (``get_avg_images.py:23-95``): [N, H, W, 3] -> [H, W, 3] float32."""
    return np.mean(np.asarray(images, np.float32), axis=0)


def _constant_pixels(mean_pixel_values: torch.Tensor, b: int) -> torch.Tensor:
    return mean_pixel_values[None].expand(b, *mean_pixel_values.shape)


class ViltForImageClassification(nn.Module):
    """Image classification with an empty text stream ([CLS] [SEP] only)."""

    def __init__(self, config: ViltModelConfig, num_labels: int, cls_token_id: int = 101,
                 sep_token_id: int = 102, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cls_token_id, self.sep_token_id = cls_token_id, sep_token_id
        self.vilt = ViltEncoder(config, dtype)
        self.task_clf = ClassificationHead(config.hidden_size, config.hidden_size, num_labels, dtype)

    def forward(self, pixel_values, pixel_mask=None, adapter_mode="none", deterministic=True):
        b = pixel_values.shape[0]
        ids = torch.tensor([[self.cls_token_id, self.sep_token_id]], dtype=torch.int32,
                           device=pixel_values.device).expand(b, 2)
        _, pooled = self.vilt(ids, torch.ones_like(ids), pixel_values=pixel_values,
                              pixel_mask=pixel_mask, adapter_mode=adapter_mode,
                              deterministic=deterministic)
        return self.task_clf(pooled)


class ViltForSequenceClassification(nn.Module):
    """Text classification against a constant (mean) image."""

    def __init__(self, config: ViltModelConfig, num_labels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.vilt = ViltEncoder(config, dtype)
        self.task_clf = ClassificationHead(config.hidden_size, config.hidden_size, num_labels, dtype)

    def forward(self, input_ids, attention_mask, mean_pixel_values, adapter_mode="none",
                deterministic=True):
        pixels = _constant_pixels(mean_pixel_values, input_ids.shape[0])
        _, pooled = self.vilt(input_ids, attention_mask, pixel_values=pixels,
                              adapter_mode=adapter_mode, deterministic=deterministic)
        return self.task_clf(pooled)


class ViltForMultipleChoice(nn.Module):
    """Text multiple choice against the mean image: input_ids [B, C, L] ->
    per-choice scores [B, C]."""

    def __init__(self, config: ViltModelConfig, num_choices: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_choices = num_choices
        self.vilt = ViltEncoder(config, dtype)
        self.task_clf = MultiChoiceHead(config.hidden_size, dtype)

    def forward(self, input_ids, attention_mask, mean_pixel_values, adapter_mode="none",
                deterministic=True):
        pixels = _constant_pixels(mean_pixel_values, input_ids.shape[0])
        pooled = torch.stack([
            self.vilt(input_ids[:, i], attention_mask[:, i], pixel_values=pixels,
                      adapter_mode=adapter_mode, deterministic=deterministic)[1]
            for i in range(self.num_choices)
        ], dim=1)
        return self.task_clf(pooled, deterministic=deterministic).squeeze(-1)
