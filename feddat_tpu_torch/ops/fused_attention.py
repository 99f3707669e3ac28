"""Whole-sequence attention for short sequences: forward and backward.

Counterpart of ``feddat_tpu/ops/fused_attention.py``.  Forward (``_fwd_kernel``
through ``_fwd_call``, kernel #5)::

    s   = q kᵀ·scale + bias_row      (fp32 logits, bf16 products exact)
    p   = exp(s − max),  l = Σ p     (fp32, exact two-pass softmax)
    o   = bf16(bf16(p)·v / l),  lse = max + log l

Backward (``_bwd_kernel`` through ``_fused_bwd``, kernel #6): P recomputed as
``exp(s − lse)``; ``dv = bf16(P)ᵀ·dO``, ``δ = rowsum(dO∘o)``,
``ds = bf16(P(dP − δ))``, ``dq = ds·k·scale``, ``dk = dsᵀ·q·scale``, each
summed in fp32 and cast once.  Every bf16 here is a cast to the operands'
dtype, so in float32 nothing rounds.

Two implementations of each:

* :func:`fused_attention_fwd_ref` / :func:`fused_attention_bwd_ref` — plain
  PyTorch with the TPU kernels' rounding points.  The CPU tests hold them
  against the JAX kernels, and ``chip_smoke.py`` holds the CUDA kernels
  against them.
* :func:`fused_attention_fwd_cuda` / :func:`fused_attention_bwd_cuda` — the
  hand-written kernels in ``csrc/fused_attention.cu`` (``wgmma`` on swizzled
  tiles filled by a cp.async ring, on strided ``[B, H, S, D]`` operands; any
  S ≥ 1 and any head dim D ≥ 1 (:func:`check_grid`), csrc/attn_any.cuh's
  kernels at every D but 64), in bf16 or float32 (the model's dtype, as the
  TPU kernels take it:
  in float32 nothing rounds, P and ds included, and every product is as
  accurate as fp32's).

:func:`fused_short_attention` is differentiable with the JAX custom_vjp's
contract (the bias is a constant) and picks by device only: a CPU tensor takes
the plain versions, a CUDA tensor launches the kernels or raises.  q/k/v are
``[B, H, S, D]`` (self-attention); ``bias`` is ``None`` or an additive
``[B or 1, 1, 1, S]`` padding bias.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from feddat_tpu_torch.ops._build import CudaKernel, ptr

_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_strides = ctypes.POINTER(ctypes.c_longlong)
KERNEL = CudaKernel(
    "fused_attention", "fused_attention_fwd",
    [_vp] * 7 + [_strides, _i, _i, _i, _i, _i, _f, _vp],  # strides, B, H, S, D, f32, scale, stream
)
KERNEL_BWD = CudaKernel(
    "fused_attention", "fused_attention_bwd",
    [_vp] * 12 + [_strides, _i, _i, _i, _i, _i, _f, _vp],
)
# The head dim of the kernels written for it (csrc/attn_sm90.cuh,
# flash_attention.cu's first kernels); every other head dim runs
# csrc/attn_any.cuh's, the dim padded to HEAD_DIM_CHUNK columns (and the
# flash backward's bf16 launches up to head dim 256 csrc/flash_dp.cuh's).
HEAD_DIM = 64
HEAD_DIM_CHUNK = 64
# gridDim.z (the batch) and gridDim.y (the heads; times the head dim's
# 64-column chunks at a head dim but 64) of a launch: what bounds the head dim.
MAX_GRID_YZ = 65535
# The element types the kernels take: q, k, v (and o, dO) all of one (lse,
# δ and the bias are fp32 either way).
DTYPES = (torch.bfloat16, torch.float32)


def _bias_rows(bias: Optional[torch.Tensor], b: int, s: int, device=None) -> torch.Tensor:
    """``fused_attention.py:88-98``: ``None`` -> zeros, a ``[B or 1, 1, 1, S]``
    padding bias -> ``[B, 1, S]`` fp32 (a batch-1 bias broadcast)."""
    if bias is None:
        return torch.zeros((b, 1, s), dtype=torch.float32, device=device)
    if not (bias.dim() == 4 and bias.shape[1] == 1 and bias.shape[2] == 1 and bias.shape[3] == s):
        raise ValueError(f"the fused path expects a [B, 1, 1, S] padding bias, got {tuple(bias.shape)}")
    return bias.to(torch.float32).expand(b, 1, 1, s).reshape(b, 1, s)


def _logits(q, k, bias, scale):
    """fp32 ``q kᵀ·scale + bias_row`` [B, H, S, S] (bf16 operands upcast, so each product is exact)."""
    b, _, s, _ = q.shape
    brow = _bias_rows(bias, b, s, q.device)
    return q.float() @ k.float().transpose(-1, -2) * scale + brow[:, :, None, :]


def fused_attention_fwd_ref(q, k, v, bias, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel #5 -> (o [B, H, S, D] in ``v.dtype``, lse [B, H, S] fp32)."""
    s = _logits(q, k, bias, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = (p.to(v.dtype).float() @ v.float() / l).to(v.dtype)
    return o, (m + torch.log(l))[..., 0]


def fused_attention_bwd_ref(q, k, v, bias, o, do, lse, scale: float):
    """Plain version of kernel #6 -> (dq, dk, dv) in the dtypes of q, k, v."""
    f32 = torch.float32
    p = torch.exp(_logits(q, k, bias, scale) - lse[..., None])
    dof = do.to(f32)
    dv = p.to(v.dtype).to(f32).transpose(-1, -2) @ dof
    dp = dof @ v.to(f32).transpose(-1, -2)
    delta = (dof * o.to(f32)).sum(-1, keepdim=True)
    ds = (p * (dp - delta)).to(q.dtype).to(f32)
    dq = ds @ k.to(f32) * scale
    dk = ds.transpose(-1, -2) @ q.to(f32) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _in_place_ok(t: torch.Tensor) -> bool:
    """Unit stride over the last dim, every other stride (of a dim longer than 1)
    a multiple of 8 elements, the data 16-byte aligned: the kernels' uint4 loads."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and not any(st % 8 for st, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1))


def check_dtypes(fn: str, operands) -> torch.dtype:
    """The element type of the ``(name, tensor)`` operands, which must all be
    one of :data:`DTYPES` (the first's); raise ``TypeError`` naming the first
    that is not.  Reads dtypes only, so it runs on any device before a launch."""
    dtype = operands[0][1].dtype
    for name, t in operands:
        if t.dtype not in DTYPES:
            raise TypeError(f"{fn}: {name} must be torch.bfloat16 or torch.float32, got {t.dtype}")
        if t.dtype != dtype:
            raise TypeError(f"{fn}: {name} must be {operands[0][0]}'s {dtype}, got {t.dtype}")
    return dtype


def check_head_dim(fn: str, d: int) -> None:
    """Raise ``ValueError`` unless the kernels take head dim ``d``: any
    ``d`` >= 1, as JAX's kernels take any (the grid bounds it with the heads:
    :func:`check_grid`)."""
    if d < 1:
        raise ValueError(f"{fn} takes head dims of at least 1; got {d}")


def check_grid(fn: str, b: int, h: int, d: int) -> None:
    """Raise ``ValueError`` unless a launch's grid takes ``b`` batch
    elements and ``h`` heads of dim ``d``: gridDim.z = B and gridDim.y = H
    times the head dim's 64-column chunks, each at most :data:`MAX_GRID_YZ`."""
    if b > MAX_GRID_YZ or h * head_dim_chunks(d) > MAX_GRID_YZ:
        raise ValueError(f"{fn}: the grid takes B <= {MAX_GRID_YZ} and heads x 64-column chunks of the head "
                         f"dim <= {MAX_GRID_YZ}; got B={b}, {h} heads x {head_dim_chunks(d)} chunks "
                         f"(head dim {d})")


def head_dim_chunks(d: int) -> int:
    """The 64-column chunks that head dim ``d`` pads to (1 at ``d`` <= 64, 4 at 256, 8 at 512)."""
    return -(-d // HEAD_DIM_CHUNK)


def padded_head_dim(d: int) -> int:
    """Head dim ``d`` padded to whole chunks: the columns the kernels compute."""
    return head_dim_chunks(d) * HEAD_DIM_CHUNK


def head_dim_kernels(d: int) -> str:
    """Which kernels a call at head dim ``d`` launches: ``"hd64"`` (the kernels
    written for 64) or ``"any"`` (csrc/attn_any.cuh's, one block per 64
    rows and output chunk)."""
    check_head_dim("head_dim_kernels", d)
    return "hd64" if d == HEAD_DIM else "any"


def fused_workspace_bytes(b: int, h: int, s: int, d: int, backward: bool, f32: bool) -> int:
    """Bytes of #5's (or #6's) scratch: float32 q, k, v (and dO) split into
    three bf16 term planes [B, H, S, D] each; none in bf16.  The library's
    ``fused_attention_workspace`` says the same (``chip_smoke.py`` phase 20
    holds the two)."""
    return (4 if backward else 3) * 3 * b * h * s * d * 2 if f32 else 0


def _check_heads(fn: str, name: str, t: torch.Tensor, shape: Tuple[int, ...]) -> None:
    """Raise unless ``t`` is a CUDA ``[B, H, S, D]`` view the kernels read in
    place: any head dim with unit stride over it, and at head dim 64
    (whose kernels copy 16 bytes at a time) :func:`_in_place_ok`; its dtype is
    :func:`check_dtypes`'s."""
    if not t.is_cuda:
        raise ValueError(f"{fn}: {name} must be a CUDA tensor")
    if t.dim() != 4:
        raise ValueError(f"{fn} takes [B, H, S, D] operands; {name} has shape {tuple(t.shape)}")
    check_head_dim(fn, t.shape[-1])
    if tuple(t.shape) != shape:
        raise ValueError(f"{fn}: {name} must have shape {shape}, got {tuple(t.shape)}")
    if t.shape[-1] == HEAD_DIM and not _in_place_ok(t):
        raise ValueError(f"{fn}: {name} needs unit stride over D, the other strides multiples of 8 "
                         f"and a 16-byte aligned start; got strides {t.stride()}")
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{fn}: {name} needs unit stride over D; got strides {t.stride()}")


def _stride_array(*ts: torch.Tensor):
    vals = [st for t in ts for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _empty_heads(b: int, h: int, s: int, device, dtype: torch.dtype, d: int = HEAD_DIM) -> torch.Tensor:
    """A [B, H, S, D] output of ``dtype`` laid out as [B, S, H, D], so that
    merging the heads back into [B, S, H·D] (or the backward of split()) is a
    free view."""
    return torch.empty((b, s, h, d), dtype=dtype, device=device).transpose(1, 2)


def _workspace(b: int, h: int, s: int, d: int, backward: bool, dtype: torch.dtype, device):
    """The float32 kernels' scratch for the operands' bf16 term planes (None in
    bf16, which needs none)."""
    if dtype != torch.float32:
        return None
    return torch.empty(fused_workspace_bytes(b, h, s, d, backward, True), dtype=torch.uint8, device=device)


def _key_bias_cuda(fn: str, bias, b: int, s: int, device) -> Optional[torch.Tensor]:
    if bias is None:
        return None
    brow = _bias_rows(bias, b, s).reshape(b, s).contiguous()
    if not brow.is_cuda or brow.device != device:
        raise ValueError(f"{fn}: bias must be on {device}")
    return brow


def fused_attention_fwd_cuda(q, k, v, bias, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel #5 -> (o, lse), as :func:`fused_attention_fwd_ref`.  Takes
    ``[B, H, S, D]`` q/k/v at any head dim D the grid takes, all bf16 or all
    float32 (o in that type), in any layout :func:`_check_heads` admits, at
    any S ≥ 1; raises on anything else."""
    fn = "fused_attention_fwd_cuda"
    operands = (("q", q), ("k", k), ("v", v))
    dtype = check_dtypes(fn, operands)
    shape = tuple(q.shape)
    for name, t in operands:
        _check_heads(fn, name, t, shape)
    b, h, s, d = shape
    if s < 1:
        raise ValueError(f"{fn}: sequence length {s} must be at least 1")
    check_grid(fn, b, h, d)
    brow = _key_bias_cuda(fn, bias, b, s, q.device)
    o = _empty_heads(b, h, s, q.device, dtype, d)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    ws = _workspace(b, h, s, d, False, dtype, q.device)
    KERNEL.launch(ptr(q), ptr(k), ptr(v), ptr(brow), ptr(o), ptr(lse), ptr(ws), _stride_array(q, k, v, o),
                  b, h, s, d, int(dtype == torch.float32), float(scale),
                  torch.cuda.current_stream(q.device).cuda_stream)
    return o, lse


def fused_attention_bwd_cuda(q, k, v, bias, o, do, lse, scale: float):
    """Kernel #6 -> (dq, dk, dv), as :func:`fused_attention_bwd_ref`.  Takes
    the forward's q/k/v/o and ``do``, all bf16 or all float32 (the gradients
    in that type), and fp32 ``lse [B, H, S]``; raises on anything else."""
    fn = "fused_attention_bwd_cuda"
    operands = (("q", q), ("k", k), ("v", v), ("o", o), ("do", do))
    dtype = check_dtypes(fn, operands)
    shape = tuple(q.shape)
    for name, t in operands:
        _check_heads(fn, name, t, shape)
    b, h, s, d = shape
    check_grid(fn, b, h, d)
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, s) or not lse.is_contiguous():
        raise ValueError(f"{fn}: lse must be a contiguous fp32 [{b}, {h}, {s}] tensor")
    brow = _key_bias_cuda(fn, bias, b, s, q.device)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    dq, dk, dv = (_empty_heads(b, h, s, q.device, dtype, d) for _ in range(3))
    ws = _workspace(b, h, s, d, True, dtype, q.device)
    KERNEL_BWD.launch(ptr(q), ptr(k), ptr(v), ptr(o), ptr(do), ptr(brow), ptr(lse), ptr(delta),
                      ptr(dq), ptr(dk), ptr(dv), ptr(ws), _stride_array(q, k, v, o, do, dq, dk, dv),
                      b, h, s, d, int(dtype == torch.float32), float(scale),
                      torch.cuda.current_stream(q.device).cuda_stream)
    return dq, dk, dv


class _FusedShortAttention(torch.autograd.Function):
    """The JAX custom_vjp's contract (fused_attention.py:123-165): q, k, v get
    gradients, the bias none."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        impl = fused_attention_fwd_cuda if q.is_cuda else fused_attention_fwd_ref
        o, lse = impl(q, k, v, bias, scale)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, o, lse = ctx.saved_tensors
        impl = fused_attention_bwd_cuda if q.is_cuda else fused_attention_bwd_ref
        if g.is_cuda and not _in_place_ok(g):  # autograd may hand over any layout of dO
            g = g.contiguous()
        dq, dk, dv = impl(q, k, v, bias, o, g, lse, ctx.scale)
        return dq, dk, dv, None, None


def fused_short_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Self-attention ``[B, H, S, D]`` -> ``[B, H, S, D]``, differentiable in
    q, k and v: the CUDA kernels for a CUDA tensor, the plain versions for a CPU
    tensor (never a fallback)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FusedShortAttention.apply(q, k, v, bias, float(scale))
