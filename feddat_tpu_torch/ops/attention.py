"""Attention core behind one routing interface, and the padding-mask bias.

Counterpart of ``feddat_tpu/ops/attention.py``: ``xla_attention`` is
``_xla_attention`` (the composable path, lines 22-57), ``dot_product_attention``
routes by ``impl`` as lines 60-141 do, and ``mask_to_bias`` is the same
-10000.0 fill (lines 144-151), with ``causal_bias`` and ``packed_self_bias``
for ALBEF's decoder (lines 154-191).  ``impl="fused"`` takes the
whole-sequence kernels (``ops/fused_attention.py``, #5/#6) where the JAX
routing rule admits the site; ``impl="flash"`` takes the flash kernels
(``ops/flash.py``, #7-#9) at every site without live dropout.  A site with
live attention dropout takes ``xla_attention`` with dropout on every route, as
in JAX (attention.py:96-106, :122-136): no kernel drops probabilities.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from feddat_tpu_torch.ops.flash import flash_attention
from feddat_tpu_torch.ops.fused_attention import fused_short_attention
from feddat_tpu_torch.ops.remat_policy import checkpoint_name
from feddat_tpu_torch.utils.seeding import keep_mask

# The JAX package's routing rule for impl="fused" (attention.py:120-125): the
# TPU kernel keeps ~4 fp32 [H, S, S] logit tiles in a 16 MiB scoped-VMEM
# budget, so sites with 4·H·S²·4 bytes above it take the composable path.  Not
# a limit of the CUDA kernels; it decides where the logits are stored in
# ``logits_dtype`` (composable path) or never stored (kernel), so the port
# routes the same sites as JAX.
FUSED_ROUTE_MAX_LOGIT_BYTES = 16 * 1024 * 1024


def xla_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],
    scale: Optional[float] = None,
    logits_dtype: torch.dtype = torch.float32,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    heads: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """softmax(q kᵀ·scale + bias) v.  q, k, v: [B, H, S, D]; returns
    [B, H, S_q, D] in ``v.dtype``.

    Rounding points follow the JAX path: the logits accumulate in fp32
    (bf16 inputs upcast, so every product is exact), are stored in
    ``logits_dtype``, the softmax runs in fp32, live dropout applies
    ``probs · keep / (1 − rate)`` in fp32 with the mask drawn from
    ``generator``, and the probabilities are cast to ``v.dtype`` before the
    P·V product.  ``heads = (first, total)``: q holds heads ``first..`` of
    ``total`` (a model rank's under tensor parallelism); the mask is drawn
    for all of them and sliced, so it is the whole model's mask."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    logits = (logits * scale).to(logits_dtype)
    if bias is not None:
        logits = logits + bias.to(logits.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    if dropout_rate > 0.0:
        shape = probs.shape if heads is None else (probs.shape[0], heads[1], *probs.shape[2:])
        keep = keep_mask(shape, 1.0 - dropout_rate, probs.device, generator)
        if heads is not None:
            keep = keep[:, heads[0]:heads[0] + probs.shape[1]]
        probs = probs * keep / (1.0 - dropout_rate)
    # remat target attn_probs (attention.py:52-56): the cast to v's dtype
    # (no op in fp32, where nothing is kept)
    with checkpoint_name("attn_probs"):
        probs = probs.to(v.dtype)
    return torch.matmul(probs, v)


def fused_route_eligible(q: torch.Tensor, k: torch.Tensor, bias: Optional[torch.Tensor],
                         dropout_rate: float) -> bool:
    """The ``impl="fused"`` gate of attention.py:120-131: no live dropout,
    self-attention lengths, a ``[B or 1, 1, 1, S]`` padding bias (or none), and
    ``4·H·S²·4`` within :data:`FUSED_ROUTE_MAX_LOGIT_BYTES`."""
    h, s = q.shape[1], q.shape[2]
    return (
        dropout_rate == 0.0
        and k.shape[2] == s
        and 4 * h * s * s * 4 <= FUSED_ROUTE_MAX_LOGIT_BYTES
        and (bias is None
             or (bias.shape[0] in (1, q.shape[0]) and bias.shape[1] == 1 and bias.shape[2] == 1))
    )


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    impl: str = "auto",
    logits_dtype: torch.dtype = torch.float32,
    heads: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Multi-head attention core, q [B, H, S_q, D], k/v [B, H, S_kv, D] ->
    [B, H, S_q, D] in ``v.dtype``.  ``"auto"``, ``"xla"`` and ``"block"`` (a
    site the block route did not take) run :func:`xla_attention`; ``"fused"``
    runs :func:`fused_short_attention` where :func:`fused_route_eligible`
    admits the site and :func:`xla_attention` elsewhere; ``"flash"`` runs
    :func:`flash_attention` at any site without live dropout and
    :func:`xla_attention` with dropout elsewhere.  ``dropout_rate`` is the
    live rate (0 when deterministic), its masks drawn from ``generator``;
    ``heads`` as :func:`xla_attention` takes it (the composable path only)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if impl not in ("auto", "xla", "block", "fused", "flash"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl == "fused" and fused_route_eligible(q, k, bias, dropout_rate):
        return fused_short_attention(q, k, v, bias, scale)
    if impl == "flash" and dropout_rate == 0.0:
        return flash_attention(q, k, v, bias, scale)
    return xla_attention(q, k, v, bias, scale, logits_dtype, dropout_rate, generator, heads)


def mask_to_bias(mask: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, S] {0,1} padding mask -> additive [B, 1, 1, S] bias with BERT's
    -10000.0 fill (``get_extended_attention_mask``)."""
    bias = (1.0 - mask.to(torch.float32)) * -10000.0
    return bias[:, None, None, :].to(dtype)


def causal_bias(seq_len: int, dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """Additive causal mask [1, 1, S, S]: 0 where key <= query, -10000 above."""
    i = torch.arange(seq_len, device=device)
    bias = torch.where(i[None, :] <= i[:, None], 0.0, -10000.0)
    return bias[None, None].to(dtype)


def packed_self_bias(mask: torch.Tensor, group: int, causal: bool,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Self-attention bias for ``group`` length-L sequences packed per row:
    [N, L] padding mask (N = G·group) -> [G, 1, group·L, group·L], block
    diagonal over the packed sequences, each key's padding at -10000, and
    causal within a sequence when ``causal``.  Exact against the unpacked
    layout: the -10000 fill underflows exp to 0 in fp32."""
    n, L = mask.shape
    G = n // group
    key = (1.0 - mask.to(torch.float32).reshape(G, group * L)) * -10000.0
    idx = torch.arange(group * L, device=mask.device)
    allowed = (idx[:, None] // L) == (idx[None, :] // L)
    if causal:
        allowed = allowed & ((idx[None, :] % L) <= (idx[:, None] % L))
    struct = torch.where(allowed, 0.0, -10000.0)
    return (key[:, None, None, :] + struct[None, None]).to(dtype)
