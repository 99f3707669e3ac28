"""Flash attention: online softmax over key tiles, with a compact additive bias.

Counterpart of ``feddat_tpu/ops/flash.py``, the long-sequence route
(``impl="flash"``).  Forward (``_flash_fwd_kernel`` through ``_flash_forward``,
kernel #7)::

    s   = (q·scale) kᵀ + bias            (fp32; bf16 products exact)
    m, l: running max (from NEG_INF) and sum over key tiles
    o   = (Σ exp(s − m)·v) / max(l, 1e-30) in v.dtype   (P stays fp32)
    lse = m + log(max(l, 1e-30))         (fp32)

Backward (``_flash_bwd_dq_kernel``/``_flash_bwd_dkv_kernel`` through
``_flash_bwd``, kernels #8/#9): P rebuilt as ``exp(s − lse)``,
``δ = rowsum(dO∘o)``, ``ds = P(dP − δ)``, ``dq = ds·k·scale``,
``dk = dsᵀ·(q·scale)``, ``dv = Pᵀ·dO``, all in fp32, cast once.

The bias is ``None`` or ``[B|1, H|1, Sq|1, Skv|1]`` (``_prep_bias``): each
size-1 dim broadcasts and is never materialised; it is a constant (no
gradient), like the JAX custom_vjp's.

* :func:`flash_attention_fwd_ref` / :func:`flash_attention_bwd_ref` — plain
  PyTorch of the same functions.  The CPU tests hold them against the Pallas
  kernels in interpret mode; ``chip_smoke.py`` holds the CUDA kernel against
  the forward one.
* :func:`flash_attention_fwd_cuda` — kernel #7, hand-written CUDA in
  ``csrc/flash_attention.cu``, reading the strided ``[B, H, S, 64]`` views
  that split() makes and the bias by strides (0 on a broadcast dim).

:func:`flash_attention` is an autograd Function with the custom_vjp's
contract: a CPU tensor takes the plain versions both ways; a CUDA tensor
launches #7 forward and raises on the backward, whose kernels (#8/#9) come
with ALBEF training (slice 5).  Nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from feddat_tpu_torch.ops._build import CudaKernel, ptr
from feddat_tpu_torch.ops.fused_attention import HEAD_DIM, _check_heads, _empty_heads

NEG_INF = -1e30

_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = CudaKernel(
    "flash_attention", "flash_attention_fwd",
    [_vp] * 6 + [ctypes.POINTER(ctypes.c_longlong), _i, _i, _i, _i, _f, _vp],
)
# gridDim.z (the batch) and gridDim.y (the heads) of the launch.
MAX_GRID_YZ = 65535


def _prep_bias(bias: Optional[torch.Tensor], b: int, h: int, sq: int,
               skv: int) -> Optional[torch.Tensor]:
    """``flash.py:164-198``: check that ``bias`` broadcasts as
    ``[B|1, H|1, Sq|1, Skv|1]`` and return it in fp32, still compact."""
    if bias is None:
        return None
    shape = tuple(bias.shape)
    if not (len(shape) == 4 and shape[0] in (1, b) and shape[1] in (1, h)
            and shape[2] in (1, sq) and shape[3] in (1, skv)):
        raise ValueError(f"flash attention takes a bias broadcastable as [B|1, H|1, Sq|1, Skv|1] "
                         f"to {(b, h, sq, skv)}; got {shape}")
    return bias.to(torch.float32)


def _logits(q, k, bias, scale):
    """fp32 ``(q·scale) kᵀ + bias`` [B, H, Sq, Skv] (bf16 operands upcast)."""
    b, h, sq, _ = q.shape
    s = (q.float() * scale) @ k.float().transpose(-1, -2)
    bias = _prep_bias(bias, b, h, sq, k.shape[2])
    return s if bias is None else s + bias


def flash_attention_fwd_ref(q, k, v, bias, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel #7 -> (o [B, H, Sq, D] in ``v.dtype``, lse [B, H, Sq] fp32).
    The TPU kernel's online softmax in closed form: the same max (from
    NEG_INF) and sum, P in fp32 times the upcast v."""
    s = _logits(q, k, bias, scale)
    m = s.amax(-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = (p @ v.float() / l).to(v.dtype)
    return o, (m + torch.log(l))[..., 0]


def flash_attention_bwd_ref(q, k, v, bias, o, do, lse, scale: float):
    """Plain versions of kernels #8 and #9 -> (dq, dk, dv) in the dtypes of q, k, v."""
    p = torch.exp(_logits(q, k, bias, scale) - lse[..., None])
    dof = do.float()
    delta = (dof * o.float()).sum(-1, keepdim=True)
    dv = p.transpose(-1, -2) @ dof
    ds = p * (dof @ v.float().transpose(-1, -2) - delta)
    dq = ds @ k.float() * scale
    dk = ds.transpose(-1, -2) @ (q.float() * scale)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_fwd_cuda(q, k, v, bias, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel #7 -> (o, lse), as :func:`flash_attention_fwd_ref`.  Takes bf16
    ``[B, H, Sq, 64]`` q and ``[B, H, Skv, 64]`` k/v in any layout
    ``_check_heads`` admits, any lengths, and the compact bias; raises on
    anything else."""
    fn = "flash_attention_fwd_cuda"
    _check_heads(fn, "q", q, tuple(q.shape))
    b, h, sq, _ = q.shape
    skv = k.shape[2] if k.dim() == 4 else -1
    for name, t in (("k", k), ("v", v)):
        _check_heads(fn, name, t, (b, h, skv, HEAD_DIM))
    if min(sq, skv) < 1 or max(b, h) > MAX_GRID_YZ:
        raise ValueError(f"{fn}: unsupported sizes B={b} H={h} Sq={sq} Skv={skv}")
    bias = _prep_bias(bias, b, h, sq, skv)
    if bias is not None and bias.device != q.device:
        raise ValueError(f"{fn}: bias must be on {q.device}")
    bias_strides = [0] * 4 if bias is None else [st if n > 1 else 0
                                                  for st, n in zip(bias.stride(), bias.shape)]
    o = _empty_heads(b, h, sq, q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    vals = [st for t in (q, k, v, o) for st in t.stride()[:3]] + bias_strides
    KERNEL.launch(ptr(q), ptr(k), ptr(v), ptr(bias), ptr(o), ptr(lse),
                  (ctypes.c_longlong * len(vals))(*vals), b, h, sq, skv, float(scale),
                  torch.cuda.current_stream(q.device).cuda_stream)
    return o, lse


class _FlashAttention(torch.autograd.Function):
    """The JAX custom_vjp's contract (flash.py:246-341): q, k, v get
    gradients, the bias none."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        impl = flash_attention_fwd_cuda if q.is_cuda else flash_attention_fwd_ref
        o, lse = impl(q, k, v, bias, scale)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, o, lse = ctx.saved_tensors
        if q.is_cuda:
            raise NotImplementedError(
                "the flash attention backward on the card needs kernels #8 and #9 "
                "(feddat_tpu/ops/flash.py::_flash_bwd_dq_kernel and _flash_bwd_dkv_kernel), "
                "which slice 5 ports (ROADMAP Queue 2)")
        dq, dk, dv = flash_attention_bwd_ref(q, k, v, bias, o, g, lse, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """``[B, H, Sq, D]`` x ``[B, H, Skv, D]`` -> ``[B, H, Sq, D]``,
    differentiable in q, k and v: kernel #7 for a CUDA tensor, the plain
    versions for a CPU tensor (never a fallback)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, bias, float(scale))
