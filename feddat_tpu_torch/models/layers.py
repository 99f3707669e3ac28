"""Shared building blocks: LayerNorm, LoRA dense, attention, MLP, pre-LN layer.

Counterpart of ``feddat_tpu/models/layers.py``.  Child names follow the flax
parameter paths (``attention.query.dense``, ``norm_before``, ``mlp.output``,
``adapter.adapter_0_down``, ...) so ``utils/param_bridge.py`` maps the JAX
parameter tree mechanically.  Parameters live in fp32, as flax keeps them;
each module computes in its ``dtype`` the way flax's ``dtype=`` does.

``attn_impl``: ``"auto"`` and ``"xla"`` run the composable path
(``ops/attention.py``); ``"fused"`` runs it with the attention core through the
whole-sequence kernels (``ops/fused_attention.py``) where JAX's gate admits
the site, so the projections, LoRA and LayerNorms stay trainable;
``"block"`` routes eligible self-attention sites through the attention-block
kernels (``ops/attn_block.py``), with ``norm_before`` fused into them when
``fuse_ln`` is set; ``"layer"`` routes an eligible whole layer through
``ops/layer_block.py`` (one backward kernel per layer) and the other layers
the ``"block"`` way; ``"flash"`` runs the composable path with the attention
core through the flash kernel (``ops/flash.py``) at every site, self- and
cross-attention alike, except that a site with live attention dropout takes
the composable path with dropout, as in JAX.

Dropout masks come from the generator that ``utils/seeding.py::dropout_rng``
makes current (``call_method(..., rng=gen)``), never from the global RNG.

Under tensor parallelism (the context ``parallel/tp.py::active`` opens) the
parameters are this rank's shards: attention runs its ``H/M`` local heads
(column-parallel q/k/v, row-parallel ``out``) and the MLP its ``I/M`` local
columns, on the composable route (``parallel/tp.py::check_model`` refuses
a kernel route); attention dropout draws the full-size mask and keeps its
heads' slice.  Without the context every one of those ops is the plain
one, on the same single body.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from feddat_tpu_torch.configs.core import AdapterSpec, LoraSpec
from feddat_tpu_torch.utils import seeding
from feddat_tpu_torch.models.adapters import MODE_ENSEMBLE, AdapterCell, dense, ensemble_members
from feddat_tpu_torch.ops import layer_block as _lb
from feddat_tpu_torch.ops.attention import dot_product_attention
from feddat_tpu_torch.ops.remat_policy import checkpoint_name, remat
from feddat_tpu_torch.parallel import tp as _tp

ATTN_IMPLS = ("auto", "xla", "block", "layer", "fused", "flash")
# Longest S at which norm_before is fused into the kernel (layers.py:494).
LN_FUSED_MAX_S = 448
# Longest S the whole-layer route takes unless FEDDAT_LAYER_MAX_S says
# otherwise, read at every gate as JAX reads it (layers.py:392).
LAYER_MAX_S = 592


def layer_max_s() -> int:
    """The whole-layer route's S cap: ``FEDDAT_LAYER_MAX_S``, else 592."""
    return int(os.environ.get("FEDDAT_LAYER_MAX_S", str(LAYER_MAX_S)))


def patch_conv2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 stride: int) -> torch.Tensor:
    """``F.conv2d(x, weight, bias, stride)`` of a patch embedding, in full
    fp32 when ``x`` is float32: cuDNN's TF32 (``torch.backends.cudnn.allow_tf32``,
    on by default in PyTorch) keeps about three decimal digits, while the JAX
    package and every float32 matmul of the port keep fp32's.  It is switched
    off for this call alone and restored after it."""
    if x.dtype != torch.float32 or not x.is_cuda:
        return F.conv2d(x, weight, bias, stride=stride)
    cudnn = torch.backends.cudnn
    allow = cudnn.allow_tf32
    cudnn.allow_tf32 = False
    try:
        return F.conv2d(x, weight, bias, stride=stride)
    finally:
        cudnn.allow_tf32 = allow


def check_attn_impl(attn_impl: str) -> str:
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {attn_impl!r}; have {ATTN_IMPLS}")
    return attn_impl


def dropout(x: torch.Tensor, rate: float, deterministic: bool) -> torch.Tensor:
    """flax ``nn.Dropout(rate)(x, deterministic)``: ``where(keep, x / (1 − rate),
    0)`` in ``x.dtype``, the mask from the current dropout generator."""
    if deterministic or rate == 0.0:
        return x
    keep = seeding.keep_mask(x.shape, 1.0 - rate, x.device, seeding.current_rng())
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: fp32 statistics with the fast variance
    ``max(E[x²]−μ², 0)``, ``(x−μ)·(rsqrt(var+eps)·scale) + bias``, cast to
    ``dtype``.  ``weight``/``bias`` are flax's ``scale``/``bias``."""

    def __init__(self, features: int, eps: float, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x: torch.Tensor, tag: Optional[str] = None) -> torch.Tensor:
        """``tag`` names the output for the remat policies: the final cast to
        ``dtype`` runs in its scope (none in fp32, where nothing is cast)."""
        xf = x.to(torch.float32)
        mu = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
        y = (xf - mu) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        with checkpoint_name(tag):
            return y.to(self.dtype)


class LoraDense(nn.Module):
    """Dense with an optional additive low-rank path (loralib ``lora.Linear``):
    ``y = Wx + b + (alpha/r)·B(Ax)``."""

    def __init__(self, in_features: int, features: int, lora: LoraSpec,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.lora = lora
        self.dtype = dtype
        self.dense = nn.Linear(in_features, features)
        if lora.enabled:
            self.lora_a = nn.Linear(in_features, lora.rank, bias=False)
            self.lora_b = nn.Linear(lora.rank, features, bias=False)

    def forward(self, x: torch.Tensor, tag: Optional[str] = None,
                tp: Optional[_tp.TPContext] = None, x_in: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """``tag`` names the base product (``dense``), not the low-rank sum.
        With ``tp`` the base product is column-parallel on ``x_in`` (``x``
        through ``copy_to_model``) and the replicated low-rank path, on ``x``,
        keeps this rank's columns."""
        y = _tp.column(x if x_in is None else x_in, self.dense, self.dtype, tp, tag)
        if self.lora.enabled:
            low = dense(dense(x, self.lora_a, self.dtype), self.lora_b, self.dtype)
            y = y + _tp.take_local(low * (self.lora.alpha / self.lora.rank), tp)
        return y


def attn_block_eligible(attn_impl: str, bias: Optional[torch.Tensor], lora: LoraSpec,
                        dropout_rate: float, deterministic: bool) -> bool:
    """``layers.py:163-173``: self-attention with a padding-row bias (or
    none), no LoRA, no live attention dropout.  Used by MultiHeadAttention
    (to route) and PreLNLayer (to decide LN fusion)."""
    return (
        attn_impl == "block"
        and (bias is None or (bias.dim() == 4 and bias.shape[1] == 1 and bias.shape[2] == 1))
        and not lora.enabled
        and not (dropout_rate > 0.0 and not deterministic)
    )


class MultiHeadAttention(nn.Module):
    """Self- or cross-attention with separate q/k/v/out projections; LoRA on
    query/value only.  Cross-attention keys and values come from ``kv``
    (``kv_features`` wide, xBERT's ``encoder_width``)."""

    def __init__(self, hidden_size: int, num_heads: int, dropout_rate: float = 0.0,
                 lora: LoraSpec = LoraSpec(), dtype: torch.dtype = torch.float32,
                 attn_impl: str = "auto", logits_dtype: torch.dtype = torch.float32,
                 kv_features: Optional[int] = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.lora = lora
        self.dtype = dtype
        self.attn_impl = check_attn_impl(attn_impl)
        self.logits_dtype = logits_dtype
        kv_features = kv_features or hidden_size
        self.query = LoraDense(hidden_size, hidden_size, lora, dtype)
        self.key = nn.Linear(kv_features, hidden_size)
        self.value = LoraDense(kv_features, hidden_size, lora, dtype)
        self.out = nn.Linear(hidden_size, hidden_size)

    def _block(self, x, bias, ln):
        from feddat_tpu_torch.ops.attn_block import attn_block

        def w(layer):
            return layer.weight.to(self.dtype).contiguous()

        bqkv = torch.stack(
            [self.query.dense.bias, self.key.bias, self.value.dense.bias]
        ).to(torch.float32)
        gb = ln_eps = None
        if ln is not None:
            gb = torch.stack([ln[0], ln[1]]).to(torch.float32)
            ln_eps = float(ln[2])
        return attn_block(
            x.to(self.dtype).contiguous(),
            w(self.query.dense), w(self.key), w(self.value.dense), w(self.out),
            bqkv, self.out.bias.to(torch.float32)[None, :], gb, bias,
            self.num_heads, (self.hidden_size // self.num_heads) ** -0.5, ln_eps,
        )

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                deterministic: bool = True, ln: Optional[tuple] = None,
                kv: Optional[torch.Tensor] = None) -> torch.Tensor:
        if kv is None and attn_block_eligible(self.attn_impl, bias, self.lora, self.dropout_rate,
                                              deterministic):
            return self._block(x, bias, ln)
        if ln is not None:
            raise ValueError(
                "fused-LN attention requested at a site that does not qualify "
                "for the block kernel (PreLNLayer must pre-check eligibility)"
            )
        d_head = self.hidden_size // self.num_heads

        def split(t):
            b, s, _ = t.shape
            return t.reshape(b, s, -1, d_head).transpose(1, 2)

        # under tensor parallelism: copy in, column-parallel q/k/v on this
        # rank's heads, row-parallel out (a sum over the model group)
        tp = _tp.current()
        x_in = _tp.copy_to_model(x, tp)
        kv, kv_in = (x, x_in) if kv is None else (kv, _tp.copy_to_model(kv, tp))
        # remat tags (layers.py:274-278, :295): q/k/v and the out projection
        q = self.query(x, "qkv", tp, x_in)
        k = _tp.column(kv_in, self.key, self.dtype, tp, "qkv")
        v = self.value(kv, "qkv", tp, kv_in)
        live = 0.0 if deterministic else self.dropout_rate
        ctx = dot_product_attention(
            split(q), split(k), split(v), bias, dropout_rate=live,
            generator=seeding.current_rng() if live > 0.0 else None,
            impl=self.attn_impl, logits_dtype=self.logits_dtype,
            heads=_tp.local_heads(self.num_heads, tp),
        )
        b, h, s, d = ctx.shape
        ctx = ctx.transpose(1, 2).reshape(b, s, h * d)
        return _tp.row(ctx, self.out, self.dtype, tp, "attn_out")


def ffn(x: torch.Tensor, intermediate: nn.Linear, output: nn.Linear,
        dtype: torch.dtype) -> torch.Tensor:
    """``intermediate -> exact GELU -> output`` (no dropout); under tensor
    parallelism on this rank's ``I/M`` columns, summed over the model group.
    The pre-GELU product is the remat target ffn_preact (layers.py:316,
    xbert.py:134-140)."""
    tp = _tp.current()
    h = F.gelu(_tp.column(_tp.copy_to_model(x, tp), intermediate, dtype, tp, "ffn_preact"))
    return _tp.row(h, output, dtype, tp)


class Mlp(nn.Module):
    """``intermediate -> exact GELU -> output`` (+ dropout)."""

    def __init__(self, hidden_size: int, intermediate_size: int, dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        self.intermediate = nn.Linear(hidden_size, intermediate_size)
        self.output = nn.Linear(intermediate_size, hidden_size)

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        h = ffn(x, self.intermediate, self.output, self.dtype)
        return dropout(h, self.dropout_rate, deterministic)


class PreLNLayer(nn.Module):
    """Pre-LayerNorm transformer layer with the DAT adapter slot::

        h   = x + attn(norm_before(x))
        o   = h + mlp(norm_after(h))
        out = o + adapter.delta(o)

    The structural remat flags (layers.py:352-360, 500-520): ``remat_attention``
    recomputes the attention sub-block alone, ``remat_ln`` the two
    LayerNorms (remat policies ``attention`` and ``min_save``); neither
    applies where the block kernel takes norm_before in."""

    def __init__(self, hidden_size: int, num_heads: int, intermediate_size: int,
                 adapter: AdapterSpec, dropout_rate: float = 0.0,
                 attention_dropout: float = 0.0, layer_norm_eps: float = 1e-12,
                 lora: LoraSpec = LoraSpec(), dtype: torch.dtype = torch.float32,
                 attn_impl: str = "auto", logits_dtype: torch.dtype = torch.float32,
                 fuse_ln: bool = False, remat_attention: bool = False,
                 remat_ln: bool = False):
        super().__init__()
        self.remat_attention = remat_attention
        self.remat_ln = remat_ln
        self.adapter_spec = adapter
        self.num_heads = num_heads
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.attention_dropout = attention_dropout
        self.layer_norm_eps = layer_norm_eps
        self.lora = lora
        self.attn_impl = check_attn_impl(attn_impl)
        self.fuse_ln = fuse_ln
        self.attention = MultiHeadAttention(
            hidden_size, num_heads, attention_dropout, lora, dtype,
            "block" if attn_impl == "layer" else attn_impl, logits_dtype,
        )
        self.norm_before = LayerNorm(hidden_size, layer_norm_eps, dtype)
        self.norm_after = LayerNorm(hidden_size, layer_norm_eps, dtype)
        self.mlp = Mlp(hidden_size, intermediate_size, dropout_rate, dtype)
        if adapter.enabled:
            self.adapter = AdapterCell(adapter, hidden_size, dtype)

    def _layer_kernel_eligible(self, bias, adapter_mode, deterministic, adapter_weights, x) -> bool:
        """``layers.py:366-393``: an enabled adapter in a mode whose gradient
        contract the kernel implements (one named adapter, or the ensemble
        whose partner is the frozen ``adapter_2`` teacher), no per-example
        adapter weights, a block-eligible site, no live hidden dropout, and
        S at most :func:`layer_max_s`.  JAX's terms and no others: #4 takes
        every bottleneck and both dtypes."""
        names = self.adapter_spec.names
        mode_ok = adapter_mode in names or (
            adapter_mode == MODE_ENSEMBLE and ensemble_members(names)[1] == "adapter_2")
        return (
            self.adapter_spec.enabled
            and mode_ok
            and adapter_weights is None
            and attn_block_eligible("block", bias, self.lora, self.attention_dropout, deterministic)
            and not (self.dropout_rate > 0.0 and not deterministic)
            and x.shape[1] <= layer_max_s()
        )

    def takes_layer_kernel(self, x, bias, adapter_mode, deterministic, adapter_weights) -> bool:
        """Whether the whole-layer kernel takes this call (``attn_impl="layer"``
        and an eligible call)."""
        return self.attn_impl == "layer" and self._layer_kernel_eligible(
            bias, adapter_mode, deterministic, adapter_weights, x)

    def _layer_kernel(self, x, bias, adapter_mode):
        """``layers.py:395-453``: the whole layer through ``ops/layer_block.py``."""
        spec, dt = self.adapter_spec, self.dtype
        if adapter_mode == MODE_ENSEMBLE:
            a_name, b_name = ensemble_members(spec.names)
            w_a = spec.ensemble_weight * spec.scaling
            w_b = (1.0 - spec.ensemble_weight) * spec.scaling
            use_b = True
        else:
            a_name = b_name = adapter_mode
            w_a, w_b, use_b = 1.0, 0.0, False
        att, mlp = self.attention, self.mlp

        def w(layer):
            return layer.weight.to(dt).contiguous()

        def row(t):
            return t.to(torch.float32)[None, :]

        def adapter(name):
            down = getattr(self.adapter, f"{name}_down")
            up = getattr(self.adapter, f"{name}_up")
            return (down.weight.t().to(dt).contiguous(), row(down.bias),
                    up.weight.t().to(dt).contiguous(), row(up.bias))

        bqkv = torch.stack([att.query.dense.bias, att.key.bias, att.value.dense.bias]).to(torch.float32)
        gb1 = torch.stack([self.norm_before.weight, self.norm_before.bias]).to(torch.float32)
        gb2 = torch.stack([self.norm_after.weight, self.norm_after.bias]).to(torch.float32)
        return _lb.layer_block(
            x.to(dt).contiguous(), w(att.query.dense), w(att.key), w(att.value.dense), w(att.out),
            bqkv, row(att.out.bias), gb1, gb2,
            w(mlp.intermediate), row(mlp.intermediate.bias), w(mlp.output), row(mlp.output.bias),
            *adapter(a_name), *adapter(b_name), bias,
            self.num_heads, None, self.layer_norm_eps, self.layer_norm_eps,
            float(w_a), float(w_b), use_b,
        )

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                adapter_mode: str = "none", deterministic: bool = True,
                adapter_weights: Optional[torch.Tensor] = None,
                whole_layer: Optional[bool] = None) -> torch.Tensor:
        """``whole_layer``: the caller's :meth:`takes_layer_kernel` for this
        call (None: decided here)."""
        if whole_layer is None:
            whole_layer = self.takes_layer_kernel(x, bias, adapter_mode, deterministic,
                                                  adapter_weights)
        if whole_layer:
            return self._layer_kernel(x, bias, adapter_mode)
        # a layer that does not qualify goes the "block" way (layers.py:468)
        impl = "block" if self.attn_impl == "layer" else self.attn_impl
        block_ok = attn_block_eligible(impl, bias, self.lora, self.attention_dropout, deterministic)
        if block_ok and self.fuse_ln and x.shape[1] <= LN_FUSED_MAX_S:
            ln = (self.norm_before.weight, self.norm_before.bias, self.layer_norm_eps)
            attn_out = self.attention(x, bias=bias, deterministic=deterministic, ln=ln)
        else:
            if self.remat_ln:
                attn_in = remat(self.norm_before, None, x)
            else:
                # the block kernel's input is the remat target attn_x (attn_block.py:347)
                attn_in = self.norm_before(x, "attn_x" if block_ok else None)
            if self.remat_attention:
                attn_out = remat(self.attention, None, attn_in, bias=bias,
                                 deterministic=deterministic)
            else:
                attn_out = self.attention(attn_in, bias=bias, deterministic=deterministic)
        h = x + dropout(attn_out, self.dropout_rate, deterministic)
        mlp_in = remat(self.norm_after, None, h) if self.remat_ln else self.norm_after(h)
        o = h + self.mlp(mlp_in, deterministic)
        if self.adapter_spec.enabled:
            o = o + self.adapter.delta(o, adapter_mode, adapter_weights)
        return o
