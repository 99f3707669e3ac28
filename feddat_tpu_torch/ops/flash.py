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
  kernels in interpret mode; ``chip_smoke.py`` holds the CUDA kernels against
  them.
* :func:`flash_attention_fwd_cuda` — kernel #7, and
  :func:`flash_attention_bwd_cuda` — kernels #8 (dq) and #9 (dk, dv), all
  hand-written CUDA in ``csrc/flash_attention.cu``, reading the strided
  ``[B, H, S, D]`` views that split() makes and the bias by strides (0 on a
  broadcast dim).  #7 and #9 are built for Hopper (``wgmma`` on 128-row
  blocks, a cp.async ring of 64-row tiles): their C entry points choose the
  grid (``ceil(Sq/128)`` query blocks for #7, ``ceil(Skv/128)`` key blocks
  for #9, by heads and batch) and raise each kernel's dynamic shared-memory
  limit once per device; #8 keeps its 64-query blocks.  All three take bf16
  or float32 operands (the model's dtype, as the TPU kernels take it; o, dq,
  dk and dv in that type): in float32 every product is as accurate as fp32's.

:func:`flash_attention` is an autograd Function with the custom_vjp's
contract: a CPU tensor takes the plain versions both ways, a CUDA tensor
launches #7 forward and #8/#9 backward or raises.  Nothing falls back.
With gradients off it calls the forward alone and keeps no residuals.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from feddat_tpu_torch.ops._build import CudaKernel, ptr
from feddat_tpu_torch.ops.fused_attention import (_check_heads, _empty_heads, _in_place_ok, check_dtypes,
                                                  check_grid)

NEG_INF = -1e30

_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_sizes = [ctypes.POINTER(ctypes.c_longlong), _i, _i, _i, _i, _i, _i, _f, _vp]  # strides, B, H, Sq, Skv, D, f32
KERNEL = CudaKernel("flash_attention", "flash_attention_fwd", [_vp] * 7 + _sizes)
KERNEL_BWD_DQ = CudaKernel("flash_attention", "flash_attention_bwd_dq", [_vp] * 9 + _sizes)
KERNEL_BWD_DKV = CudaKernel("flash_attention", "flash_attention_bwd_dkv", [_vp] * 10 + _sizes)


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


def flash_workspace_bytes(b: int, h: int, sq: int, skv: int, d: int, backward: bool, f32: bool) -> int:
    """Bytes of #7's (or #8/#9's shared) scratch: float32 q, k, v (and dO)
    split into three bf16 term planes [B, H, S, D] each; none in bf16.  The
    library's ``flash_attention_workspace`` says the same (``chip_smoke.py``
    phase 20 holds the two)."""
    if not f32:
        return 0
    return 2 * 3 * d * b * h * ((2 if backward else 1) * sq + 2 * skv)


def _check_cuda_operands(fn: str, q, k, v, bias):
    """The checks #7-#9 share: ``[B, H, Sq, D]`` q and ``[B, H, Skv, D]``
    k/v at any head dim D (their one dtype checked by
    ``check_dtypes`` before) in any layout ``_check_heads`` admits (at D = 64
    a 16-byte aligned start and strides of multiples of 8 elements: those
    kernels copy rows 16 bytes at a time with cp.async), sizes the grid
    takes, a compact bias on q's device.  -> (b, h, sq, skv, fp32 bias or
    None, its 4 element strides with 0 on broadcast dims)."""
    _check_heads(fn, "q", q, tuple(q.shape))
    b, h, sq, d = q.shape
    skv = k.shape[2] if k.dim() == 4 else -1
    for name, t in (("k", k), ("v", v)):
        _check_heads(fn, name, t, (b, h, skv, d))
    if min(sq, skv) < 1:
        raise ValueError(f"{fn}: unsupported sizes B={b} H={h} Sq={sq} Skv={skv}")
    check_grid(fn, b, h, d)
    bias = _prep_bias(bias, b, h, sq, skv)
    if bias is not None and bias.device != q.device:
        raise ValueError(f"{fn}: bias must be on {q.device}")
    bias_strides = [0] * 4 if bias is None else [st if n > 1 else 0
                                                  for st, n in zip(bias.stride(), bias.shape)]
    return b, h, sq, skv, bias, bias_strides


def _strides(ts, bias_strides):
    vals = [st for t in ts for st in t.stride()[:3]] + bias_strides
    return (ctypes.c_longlong * len(vals))(*vals)


def _workspace(b: int, h: int, sq: int, skv: int, d: int, backward: bool, dtype: torch.dtype, device):
    """The float32 kernels' scratch for the operands' bf16 term planes (None in
    bf16, which needs none); the backward's two launches share one."""
    if dtype != torch.float32:
        return None
    return torch.empty(flash_workspace_bytes(b, h, sq, skv, d, backward, True), dtype=torch.uint8,
                       device=device)


def flash_attention_fwd_cuda(q, k, v, bias, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel #7 -> (o, lse), as :func:`flash_attention_fwd_ref`.  Takes
    ``[B, H, Sq, D]`` q and ``[B, H, Skv, D]`` k/v at any head dim D the grid
    takes (``check_grid``), all bf16 or all float32 (o in that type), in any
    layout ``_check_heads`` admits, any lengths, and the compact bias; raises
    on anything else."""
    fn = "flash_attention_fwd_cuda"
    dtype = check_dtypes(fn, (("q", q), ("k", k), ("v", v)))
    b, h, sq, skv, bias, bias_strides = _check_cuda_operands(fn, q, k, v, bias)
    d = q.shape[-1]
    o = _empty_heads(b, h, sq, q.device, dtype, d)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    ws = _workspace(b, h, sq, skv, d, False, dtype, q.device)
    KERNEL.launch(ptr(q), ptr(k), ptr(v), ptr(bias), ptr(o), ptr(lse), ptr(ws),
                  _strides((q, k, v, o), bias_strides), b, h, sq, skv, d, int(dtype == torch.float32),
                  float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    return o, lse


def flash_attention_bwd_cuda(q, k, v, bias, o, do, lse, scale: float):
    """Kernels #8 (dq) and #9 (dk, dv) -> (dq, dk, dv), as
    :func:`flash_attention_bwd_ref`.  Takes the forward's operands as
    :func:`flash_attention_fwd_cuda` does, its o and fp32 lse, and ``do`` in
    any layout ``_check_heads`` admits, q/k/v/o/do all bf16 or all float32
    (the gradients in that type); δ = rowsum(dO∘o) is one fp32 reduction here,
    as JAX takes it in XLA.  Raises before any launch on another dtype
    (``TypeError``), a head dim of 0, a bias on another device or
    anything else the kernels do not take (``ValueError``)."""
    launch_dq, launch_dkv, grads = flash_bwd_launchers(q, k, v, bias, o, do, lse, scale)
    launch_dq()
    launch_dkv()
    return grads


def flash_bwd_launchers(q, k, v, bias, o, do, lse, scale: float):
    """The checks, δ and the outputs of :func:`flash_attention_bwd_cuda` ->
    (launch #8, launch #9, (dq, dk, dv)): each launcher runs its kernel into
    the returned outputs (``chip_smoke.py`` times them one by one).  In
    float32 #8's launch also splits q, k, v and dO into the workspace's term
    planes, which #9's reads: launch #8 first."""
    fn = "flash_attention_bwd_cuda"
    dtype = check_dtypes(fn, (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)))
    b, h, sq, skv, bias, bias_strides = _check_cuda_operands(fn, q, k, v, bias)
    d = q.shape[-1]
    for name, t in (("o", o), ("do", do)):
        _check_heads(fn, name, t, (b, h, sq, d))
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, sq) or not lse.is_contiguous():
        raise ValueError(f"{fn}: lse must be a contiguous fp32 [{b}, {h}, {sq}] tensor")
    delta = (do.float() * o.float()).sum(-1).contiguous()
    dq = _empty_heads(b, h, sq, q.device, dtype, d)
    dk, dv = _empty_heads(b, h, skv, q.device, dtype, d), _empty_heads(b, h, skv, q.device, dtype, d)
    ws = _workspace(b, h, sq, skv, d, True, dtype, q.device)
    strides = _strides((q, k, v, do, dq, dk, dv), bias_strides)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    f32 = int(dtype == torch.float32)

    def launcher(kernel, *outs):  # holds every operand (δ and the workspace included) while it lives
        return lambda: kernel.launch(ptr(q), ptr(k), ptr(v), ptr(do), ptr(bias), ptr(lse), ptr(delta),
                                     *map(ptr, outs), ptr(ws), strides, b, h, sq, skv, d, f32, float(scale),
                                     stream)

    return launcher(KERNEL_BWD_DQ, dq), launcher(KERNEL_BWD_DKV, dk, dv), (dq, dk, dv)


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
        impl = flash_attention_bwd_cuda if q.is_cuda else flash_attention_bwd_ref
        if g.is_cuda and not _in_place_ok(g):  # autograd may hand over any layout of dO
            g = g.contiguous()
        dq, dk, dv = impl(q, k, v, bias, o, g, lse, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """``[B, H, Sq, D]`` x ``[B, H, Skv, D]`` -> ``[B, H, Sq, D]``,
    differentiable in q, k and v: kernels #7-#9 for a CUDA tensor, the plain
    versions for a CPU tensor (never a fallback)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not torch.is_grad_enabled():
        # no autograd node: nothing is saved for a backward (the momentum
        # twin's forward); lse, the kernel's second output, is dropped here
        impl = flash_attention_fwd_cuda if q.is_cuda else flash_attention_fwd_ref
        return impl(q, k, v, bias, float(scale))[0]
    return _FlashAttention.apply(q, k, v, bias, float(scale))
