"""Plain attention core and the padding-mask bias.

Counterpart of ``feddat_tpu/ops/attention.py``: ``xla_attention`` is
``_xla_attention`` (the composable path, lines 22-57) and ``mask_to_bias``
is the same -10000.0 fill (lines 144-151).  The "flash" and "fused" Pallas
routes of ``dot_product_attention`` are later slices (ROADMAP Queue 2).
"""

from __future__ import annotations

from typing import Optional

import torch


def xla_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],
    scale: Optional[float] = None,
    logits_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """softmax(q kᵀ·scale + bias) v.  q, k, v: [B, H, S, D]; returns
    [B, H, S_q, D] in ``v.dtype``.

    Rounding points follow the JAX path: the logits accumulate in fp32
    (bf16 inputs upcast, so every product is exact), are stored in
    ``logits_dtype``, the softmax runs in fp32, and the probabilities are
    cast to ``v.dtype`` before the P·V product."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    logits = (logits * scale).to(logits_dtype)
    if bias is not None:
        logits = logits + bias.to(logits.dtype)
    probs = torch.softmax(logits.float(), dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def mask_to_bias(mask: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, S] {0,1} padding mask -> additive [B, 1, 1, S] bias with BERT's
    -10000.0 fill (``get_extended_attention_mask``)."""
    bias = (1.0 - mask.to(torch.float32)) * -10000.0
    return bias[:, None, None, :].to(dtype)
