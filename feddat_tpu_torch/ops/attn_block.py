"""Fused pre-LN attention block, forward (frozen projections).

Counterpart of ``feddat_tpu/ops/attn_block.py`` (``_fwd_kernel`` through
``_fwd_call``)::

    xln   = LayerNorm(x)          (optional, fused: gb / ln_eps)
    q/k/v = xln · Wᵀ + b          (bf16 inputs, fp32 accumulation)
    ctx   = softmax(q kᵀ·scale + bias) v   (per head, fp32 logits)
    out   = ctx · Woᵀ + bo

Two implementations of one function:

* :func:`attn_block_reference` — plain PyTorch with the TPU kernel's
  rounding points.  The CPU tests hold it against the JAX kernel, and
  ``chip_smoke.py`` holds the CUDA kernel against it.
* :func:`attn_block_cuda` — the hand-written kernel in ``csrc/attn_block.cu``.

:func:`attn_block` picks by device only: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises.

Weights use the ``nn.Linear`` layout ``[out, in]``.  ``bias`` is the
additive ``[B, 1, 1, S]`` padding bias (or None).  The backward kernel
(``_bwd_kernel``) is a later slice, so the CUDA path refuses inputs that
require grad.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from feddat_tpu_torch.ops._build import CudaKernel, load, ptr

_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = CudaKernel(
    "attn_block", "attn_block_fwd",
    [_vp] * 13 + [_i, _i, _i, _i, _f, _f, _vp],
)
# Head dim and width multiple the kernel is written for (mma tiles).
HEAD_DIM = 64
WIDTH_MULTIPLE = 128


@functools.cache
def _max_seq() -> int:
    """Longest S whose fp32 logits tile fits a block's shared memory."""
    fn = load("attn_block").attn_block_max_seq
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


def _key_bias(bias: Optional[torch.Tensor], b: int, s: int) -> Optional[torch.Tensor]:
    """[B or 1, 1, 1, S] additive bias -> [B, S] fp32 (batch-broadcast expanded)."""
    if bias is None:
        return None
    if not (bias.dim() == 4 and bias.shape[1] == 1 and bias.shape[2] == 1 and bias.shape[3] == s):
        raise ValueError(f"attn_block expects a [B, 1, 1, S] padding bias, got {tuple(bias.shape)}")
    return bias.to(torch.float32).reshape(bias.shape[0], s).expand(b, s)


def layer_norm_fast_variance(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                             eps: float) -> torch.Tensor:
    """The kernel's LN (attn_block.py:68-87): fp32, ``max(E[x²]−μ², 0)``,
    ``(x−μ)·rstd·scale + shift``; returns fp32."""
    xr = x.to(torch.float32)
    mu = xr.mean(-1, keepdim=True)
    var = torch.clamp((xr * xr).mean(-1, keepdim=True) - mu * mu, min=0.0)
    return (xr - mu) * torch.rsqrt(var + eps) * scale + shift


def attn_block_reference(x, wq, wk, wv, wo, bqkv, bo, gb, bias, num_heads: int,
                         scale: Optional[float] = None, ln_eps: Optional[float] = None,
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version -> (out [B,S,Dm], ctx [B,S,Dm], lse [B,H,S] fp32).

    Rounds where the TPU kernel rounds: q/k/v and ctx and out are cast to
    ``x.dtype`` after an fp32 accumulation (bf16 operands upcast first, so
    each product is exact); the logits and softmax stay fp32 and P is cast
    to ``x.dtype`` before P·V."""
    dt = x.dtype
    b, s, dm = x.shape
    d = dm // num_heads
    if scale is None:
        scale = d ** -0.5
    xin = x
    if ln_eps is not None:
        xin = layer_norm_fast_variance(x, gb[0], gb[1], ln_eps).to(dt)
    xf = xin.to(torch.float32)

    def proj(w, bvec):
        return (xf @ w.to(torch.float32).t() + bvec).to(dt)

    def heads(t):
        return t.reshape(b, s, num_heads, d).transpose(1, 2).to(torch.float32)

    q, k, v = (proj(w, bqkv[i]) for i, w in enumerate((wq, wk, wv)))
    logits = heads(q) @ heads(k).transpose(-1, -2) * scale
    brow = _key_bias(bias, b, s)
    if brow is not None:
        logits = logits + brow[:, None, None, :]
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(-1, keepdim=True)
    ch = p.to(dt).to(torch.float32) @ heads(v)
    ctx = (ch / l).to(dt).transpose(1, 2).reshape(b, s, dm)
    lse = (m + torch.log(l))[..., 0]
    out = (ctx.to(torch.float32) @ wo.to(torch.float32).t() + bo.reshape(-1)).to(dt)
    return out, ctx, lse


def _check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, shape: Tuple[int, ...]):
    if not t.is_cuda:
        raise ValueError(f"attn_block_cuda: {name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"attn_block_cuda: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"attn_block_cuda: {name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"attn_block_cuda: {name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"attn_block_cuda: {name} must start on a 16-byte boundary")


def attn_block_cuda(x, wq, wk, wv, wo, bqkv, bo, gb, bias, num_heads: int,
                    scale: Optional[float] = None, ln_eps: Optional[float] = None,
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CUDA kernel -> (out, ctx, lse), as :func:`attn_block_reference`.

    Takes bf16 ``x [B, S, Dm]`` and weights ``[Dm, Dm]``, fp32 ``bqkv [3, Dm]``,
    ``bo [1, Dm]``, ``gb [2, Dm]`` (with ``ln_eps``) and ``bias``; requires
    ``Dm / num_heads == 64`` and ``Dm % 128 == 0``.  Raises on anything else."""
    tensors = [x, wq, wk, wv, wo, bqkv, bo, gb, bias]
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            "attn_block_cuda has no backward yet (the attention-block backward "
            "kernel #3 is in ROADMAP Queue 2); run it under torch.no_grad/inference_mode"
        )
    if x.dim() != 3:
        raise ValueError(f"attn_block_cuda: x must be [B, S, Dm], got {tuple(x.shape)}")
    b, s, dm = x.shape
    if dm % num_heads or dm // num_heads != HEAD_DIM or dm % WIDTH_MULTIPLE:
        raise ValueError(
            f"attn_block_cuda takes head dim {HEAD_DIM} and a width that is a multiple "
            f"of {WIDTH_MULTIPLE}; got width {dm} with {num_heads} heads"
        )
    _check_cuda("x", x, torch.bfloat16, (b, s, dm))
    for name, w in zip(("wq", "wk", "wv", "wo"), (wq, wk, wv, wo)):
        _check_cuda(name, w, torch.bfloat16, (dm, dm))
    _check_cuda("bqkv", bqkv, torch.float32, (3, dm))
    _check_cuda("bo", bo, torch.float32, (1, dm))
    if (gb is None) != (ln_eps is None):
        raise ValueError("attn_block_cuda: pass gb and ln_eps together (fused LN) or neither")
    if gb is not None:
        _check_cuda("gb", gb, torch.float32, (2, dm))
    brow = _key_bias(bias, b, s)
    if brow is not None:
        brow = brow.contiguous()
        _check_cuda("bias", brow, torch.float32, (b, s))
    max_s = _max_seq()
    if s > max_s or s < 1:
        raise ValueError(f"attn_block_cuda: sequence length {s} outside [1, {max_s}]")
    if scale is None:
        scale = HEAD_DIM ** -0.5
    qkv = torch.empty((3, b * s, dm), dtype=torch.bfloat16, device=x.device)
    ctx = torch.empty_like(x)
    out = torch.empty_like(x)
    lse = torch.empty((b, num_heads, s), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    KERNEL.launch(
        ptr(x), ptr(wq), ptr(wk), ptr(wv), ptr(wo), ptr(bqkv), ptr(bo), ptr(gb), ptr(brow),
        ptr(qkv), ptr(ctx), ptr(lse), ptr(out),
        b, s, dm, num_heads, float(scale), float(ln_eps or 0.0), stream,
    )
    return out, ctx, lse


def attn_block(x, wq, wk, wv, wo, bqkv, bo, gb, bias, num_heads: int,
               scale: Optional[float] = None, ln_eps: Optional[float] = None) -> torch.Tensor:
    """The attention block's output ``[B, S, Dm]``: the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor (never a fallback)."""
    impl = attn_block_cuda if x.is_cuda else attn_block_reference
    return impl(x, wq, wk, wv, wo, bqkv, bo, gb, bias, num_heads, scale, ln_eps)[0]
