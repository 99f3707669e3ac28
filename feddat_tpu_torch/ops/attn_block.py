"""Fused pre-LN attention block with frozen projections: forward and backward.

Counterpart of ``feddat_tpu/ops/attn_block.py``.  Forward (``_fwd_kernel``
through ``_fwd_call``, kernel #1)::

    xln   = LayerNorm(x)          (optional, fused: gb / ln_eps)
    q/k/v = xln · Wᵀ + b          (bf16 inputs, fp32 accumulation)
    ctx   = softmax(q kᵀ·scale + bias) v   (per head, fp32 logits)
    out   = ctx · Woᵀ + bo

Backward (``_bwd_kernel`` through ``_attn_block_bwd``, kernel #3): ``dx`` only,
recomputing LN1 and q/k/v from ``x`` and the saved ``ctx``/``lse``; the
projections, biases, LN parameters and the mask get no gradient.

Two implementations of each:

* :func:`attn_block_reference` / :func:`attn_block_bwd_reference` — plain
  PyTorch with the TPU kernels' rounding points.  The CPU tests hold them
  against the JAX kernels, and ``chip_smoke.py`` holds the CUDA kernels
  against them.
* :func:`attn_block_cuda` / :func:`attn_block_bwd_cuda` — the hand-written
  kernels in ``csrc/attn_block.cu`` (the backward's attention part is
  ``csrc/attn_bwd.cuh``, shared with the whole-layer backward; the attention
  cores both ways are ``csrc/attn_sm90.cuh``'s wgmma kernels, which #5 and
  #6 run too, and ``csrc/attn_any.cuh``'s at a head dim other than 64):
  any S >= 1, any width that divides into heads, in bf16 or
  float32 (the model's dtype, as the TPU
  kernels take it; float32 rounds nowhere and its products are as accurate
  as fp32's).

:func:`attn_block` is differentiable with the JAX custom_vjp's contract and
picks by device only: a CPU tensor takes the plain versions, a CUDA tensor
launches the kernels or raises.  As in JAX, past ``LN_BWD_FUSED_MAX_S`` the
backward takes LN1 outside the kernel (attn_block.py:358-385, 410-415).

Weights use the ``nn.Linear`` layout ``[out, in]``.  ``bias`` is the
additive ``[B, 1, 1, S]`` padding bias (or None).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from feddat_tpu_torch.ops._build import CudaKernel, load, ptr
from feddat_tpu_torch.ops.fused_attention import check_grid
from feddat_tpu_torch.ops.remat_policy import checkpoint_name

_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = CudaKernel(
    "attn_block", "attn_block_fwd",
    [_vp] * 13 + [_i] * 5 + [_f, _f, _vp],
)
KERNEL_BWD = CudaKernel(
    "attn_block", "attn_block_bwd",
    [_vp] * 13 + [_i] * 5 + [_f, _f, _vp],
)
# The element types the kernels take (activations and weights; biases, LN
# rows, the padding bias and lse are fp32 either way).
DTYPES = (torch.bfloat16, torch.float32)
# Longest padded S at which the backward keeps LN1 fused (attn_block.py:358).
LN_BWD_FUSED_MAX_S = 448


def _key_bias(bias: Optional[torch.Tensor], b: int, s: int) -> Optional[torch.Tensor]:
    """[B or 1, 1, 1, S] additive bias -> [B, S] fp32 (batch-broadcast expanded)."""
    if bias is None:
        return None
    if not (bias.dim() == 4 and bias.shape[1] == 1 and bias.shape[2] == 1 and bias.shape[3] == s):
        raise ValueError(f"attn_block expects a [B, 1, 1, S] padding bias, got {tuple(bias.shape)}")
    return bias.to(torch.float32).reshape(bias.shape[0], s).expand(b, s)


def layer_norm_stats(x: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xhat, rstd) of the kernels' LayerNorm (attn_block.py:68-87): fp32,
    ``var = max(E[x²]−μ², 0)``, ``xhat = (x−μ)·rsqrt(var+eps)``."""
    xr = x.to(torch.float32)
    mu = xr.mean(-1, keepdim=True)
    var = torch.clamp((xr * xr).mean(-1, keepdim=True) - mu * mu, min=0.0)
    rstd = torch.rsqrt(var + eps)
    return (xr - mu) * rstd, rstd


def layer_norm_fast_variance(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                             eps: float) -> torch.Tensor:
    """The kernels' LayerNorm ``xhat·scale + shift``, fp32."""
    return layer_norm_stats(x, eps)[0] * scale + shift


def layer_norm_bwd(dy: torch.Tensor, xhat: torch.Tensor, rstd: torch.Tensor,
                   gamma: torch.Tensor) -> torch.Tensor:
    """d x of a LayerNorm with a frozen scale (layer_block.py:79-84), fp32."""
    dxhat = dy.to(torch.float32) * gamma
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    return rstd * (dxhat - m1 - xhat * m2)


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


def check_cuda_arg(fn: str, name: str, t: torch.Tensor, dtype: torch.dtype,
                   shape: Tuple[int, ...]):
    """Raise unless ``t`` is a contiguous, 16-byte aligned CUDA tensor of
    ``dtype`` and ``shape`` (what the kernels' vector loads assume)."""
    if not t.is_cuda:
        raise ValueError(f"{fn}: {name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{fn}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{fn}: {name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{fn}: {name} must start on a 16-byte boundary")


def kernel_dtype(fn: str, x: torch.Tensor) -> torch.dtype:
    """``x.dtype`` if the kernels take it (bf16 or float32), else raise."""
    if x.dtype not in DTYPES:
        raise TypeError(f"{fn} takes bf16 or float32 activations, got {x.dtype}")
    return x.dtype


def check_heads(fn: str, dm: int, num_heads: int) -> None:
    """Raise unless width ``dm`` divides into ``num_heads`` heads of any width
    (the GEMMs take every N, K and segment) that the attention core's grid
    takes (``fused_attention.check_grid``)."""
    if num_heads < 1 or dm < num_heads or dm % num_heads:
        raise ValueError(f"{fn} takes a width that divides into heads; got width {dm} with {num_heads} heads")
    check_grid(fn, 1, num_heads, dm // num_heads)


def attn_block_cuda(x, wq, wk, wv, wo, bqkv, bo, gb, bias, num_heads: int,
                    scale: Optional[float] = None, ln_eps: Optional[float] = None,
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CUDA kernel -> (out, ctx, lse), as :func:`attn_block_reference`.

    Takes ``x [B, S, Dm]`` and weights ``[Dm, Dm]`` in bf16 or float32 (one
    type), fp32 ``bqkv [3, Dm]``, ``bo [1, Dm]``, ``gb [2, Dm]`` (with
    ``ln_eps``) and ``bias``; any Dm that divides into heads
    (:func:`check_heads`) and any S >= 1.  Raises on anything else."""
    fn = "attn_block_cuda"
    if x.dim() != 3:
        raise ValueError(f"{fn}: x must be [B, S, Dm], got {tuple(x.shape)}")
    b, s, dm = x.shape
    check_heads(fn, dm, num_heads)
    dt = kernel_dtype(fn, x)
    check_cuda_arg(fn, "x", x, dt, (b, s, dm))
    for name, w in zip(("wq", "wk", "wv", "wo"), (wq, wk, wv, wo)):
        check_cuda_arg(fn, name, w, dt, (dm, dm))
    check_cuda_arg(fn, "bqkv", bqkv, torch.float32, (3, dm))
    check_cuda_arg(fn, "bo", bo, torch.float32, (1, dm))
    if (gb is None) != (ln_eps is None):
        raise ValueError("attn_block_cuda: pass gb and ln_eps together (fused LN) or neither")
    if gb is not None:
        check_cuda_arg(fn, "gb", gb, torch.float32, (2, dm))
    brow = _key_bias(bias, b, s)
    if brow is not None:
        brow = brow.contiguous()
        check_cuda_arg(fn, "bias", brow, torch.float32, (b, s))
    if s < 1:
        raise ValueError(f"{fn}: x holds no tokens (S = {s})")
    if scale is None:
        scale = (dm // num_heads) ** -0.5
    f32 = int(dt == torch.float32)
    ws = torch.empty(_fwd_workspace(b, s, dm, f32), dtype=torch.uint8, device=x.device)
    ctx = torch.empty_like(x)
    out = torch.empty_like(x)
    lse = torch.empty((b, num_heads, s), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    KERNEL.launch(
        ptr(x), ptr(wq), ptr(wk), ptr(wv), ptr(wo), ptr(bqkv), ptr(bo), ptr(gb), ptr(brow),
        ptr(ws), ptr(ctx), ptr(lse), ptr(out),
        b, s, dm, num_heads, f32, float(scale), float(ln_eps or 0.0), stream,
    )
    return out, ctx, lse


@functools.cache
def _fwd_workspace(b: int, s: int, dm: int, f32: int) -> int:
    fn = load("attn_block").attn_block_fwd_workspace
    fn.argtypes, fn.restype = [_i] * 4, ctypes.c_longlong
    return fn(b, s, dm, f32)


def attn_bwd_core_reference(xin, wq, wk, wv, wo, bqkv, brow, ctx, lse, g_att,
                            num_heads: int, scale: float) -> torch.Tensor:
    """The attention half of kernels #3 and #4 (attn_block.py:150-210,
    layer_block.py:244-298) in plain PyTorch -> ``dxln`` fp32 [B, S, Dm].

    ``xin`` is the block's (LayerNormed) bf16 input, ``brow`` the [B, S]
    fp32 key bias or None, ``g_att`` the bf16 cotangent of the output.
    Rounds where the TPU kernel rounds: dctx, q/k/v, bf16(P), dv, ds, dq, dk
    in ``xin.dtype``; logits, P, dP, delta and dxln in fp32."""
    dt = xin.dtype
    b, s, dm = xin.shape
    d = dm // num_heads
    f32 = torch.float32
    xf = xin.to(f32)

    def heads(t):
        return t.reshape(b, s, num_heads, d).transpose(1, 2).to(f32)

    def merge(t):
        return t.transpose(1, 2).reshape(b, s, dm)

    dctx = (g_att.to(f32) @ wo.to(f32)).to(dt)
    q, k, v = (heads((xf @ w.to(f32).t() + bqkv[i]).to(dt)) for i, w in enumerate((wq, wk, wv)))
    do, o = heads(dctx), heads(ctx)
    logits = q @ k.transpose(-1, -2) * scale
    if brow is not None:
        logits = logits + brow[:, None, None, :]
    p = torch.exp(logits - lse[..., None])
    dv = (p.to(dt).to(f32).transpose(-1, -2) @ do).to(dt)
    dp = do @ v.transpose(-1, -2)
    delta = (do * o).sum(-1, keepdim=True)
    ds = (p * (dp - delta)).to(dt).to(f32)
    dq = (ds @ k * scale).to(dt)
    dk = (ds.transpose(-1, -2) @ q * scale).to(dt)
    return sum(merge(t).to(f32) @ w.to(f32) for t, w in ((dq, wq), (dk, wk), (dv, wv)))


def attn_block_bwd_reference(x, wq, wk, wv, wo, bqkv, gb, bias, ctx, lse, g, num_heads: int,
                             scale: Optional[float] = None,
                             ln_eps: Optional[float] = None) -> torch.Tensor:
    """Plain version of kernel #3 -> ``dx`` in ``x.dtype`` (LN1 fused when
    ``gb``/``ln_eps`` are given: dxln goes back through the LayerNorm in
    fp32 before the one cast, attn_block.py:211-238)."""
    b, s, dm = x.shape
    if scale is None:
        scale = (dm // num_heads) ** -0.5
    xin = x
    if ln_eps is not None:
        xhat, rstd = layer_norm_stats(x, ln_eps)
        xin = (xhat * gb[0] + gb[1]).to(x.dtype)
    dxln = attn_bwd_core_reference(xin, wq, wk, wv, wo, bqkv, _key_bias(bias, b, s), ctx, lse,
                                   g, num_heads, scale)
    if ln_eps is not None:
        dxln = layer_norm_bwd(dxln, xhat, rstd, gb[0])
    return dxln.to(x.dtype)


@functools.cache
def _bwd_workspace(b: int, s: int, dm: int, h: int, has_ln: bool, f32: int) -> int:
    fn = load("attn_block").attn_block_bwd_workspace
    fn.argtypes, fn.restype = [_i] * 6, ctypes.c_longlong
    return fn(b, s, dm, h, int(has_ln), f32)


def attn_block_bwd_cuda(x, wq, wk, wv, wo, bqkv, gb, bias, ctx, lse, g, num_heads: int,
                        scale: Optional[float] = None,
                        ln_eps: Optional[float] = None) -> torch.Tensor:
    """Kernel #3 -> ``dx``, as :func:`attn_block_bwd_reference`.  Takes the
    forward's ``x``/weights (bf16 or float32) and fp32 ``bqkv``/``gb``/
    ``bias``, its ``ctx`` and fp32 ``lse [B, H, S]``, and ``g`` (``x``'s
    type); the same shape limits as :func:`attn_block_cuda`.  Raises on
    anything else."""
    fn = "attn_block_bwd_cuda"
    if x.dim() != 3:
        raise ValueError(f"{fn}: x must be [B, S, Dm], got {tuple(x.shape)}")
    b, s, dm = x.shape
    check_heads(fn, dm, num_heads)
    dt = kernel_dtype(fn, x)
    for name, t, dtype, shape in (
        ("x", x, dt, (b, s, dm)), ("ctx", ctx, dt, (b, s, dm)),
        ("g", g, dt, (b, s, dm)), ("lse", lse, torch.float32, (b, num_heads, s)),
        ("bqkv", bqkv, torch.float32, (3, dm)),
        *((name, w, dt, (dm, dm)) for name, w in zip(("wq", "wk", "wv", "wo"), (wq, wk, wv, wo))),
    ):
        check_cuda_arg(fn, name, t, dtype, shape)
    if (gb is None) != (ln_eps is None):
        raise ValueError(f"{fn}: pass gb and ln_eps together (fused LN) or neither")
    if gb is not None:
        check_cuda_arg(fn, "gb", gb, torch.float32, (2, dm))
    brow = _key_bias(bias, b, s)
    if brow is not None:
        brow = brow.contiguous()
        check_cuda_arg(fn, "bias", brow, torch.float32, (b, s))
    if s < 1:
        raise ValueError(f"{fn}: x holds no tokens (S = {s})")
    if scale is None:
        scale = (dm // num_heads) ** -0.5
    f32 = int(dt == torch.float32)
    ws = torch.empty(_bwd_workspace(b, s, dm, num_heads, gb is not None, f32), dtype=torch.uint8,
                     device=x.device)
    dx = torch.empty_like(x)
    KERNEL_BWD.launch(
        ptr(x), ptr(wq), ptr(wk), ptr(wv), ptr(wo), ptr(bqkv), ptr(gb), ptr(brow), ptr(ctx),
        ptr(lse), ptr(g), ptr(ws), ptr(dx), b, s, dm, num_heads, f32, float(scale),
        float(ln_eps or 0.0), torch.cuda.current_stream(x.device).cuda_stream,
    )
    return dx


def attn_block_bwd(x, wq, wk, wv, wo, bqkv, gb, bias, ctx, lse, g, num_heads: int,
                   scale: Optional[float] = None, ln_eps: Optional[float] = None) -> torch.Tensor:
    """``dx`` of the attention block: kernel #3 for a CUDA tensor, the plain
    version for a CPU tensor.  Past ``LN_BWD_FUSED_MAX_S`` (padded to 16, as
    JAX pads) the LayerNorm runs outside the kernel, as in
    ``_attn_block_bwd``: the kernel sees the bf16 LN output and its bf16 dx
    goes back through the LayerNorm in fp32."""
    impl = attn_block_bwd_cuda if x.is_cuda else attn_block_bwd_reference
    s = x.shape[1]
    if ln_eps is None or -(-s // 16) * 16 <= LN_BWD_FUSED_MAX_S:
        return impl(x, wq, wk, wv, wo, bqkv, gb, bias, ctx, lse, g, num_heads, scale, ln_eps)
    xhat, rstd = layer_norm_stats(x, ln_eps)
    kernel_x = (xhat * gb[0] + gb[1]).to(x.dtype)
    dx = impl(kernel_x, wq, wk, wv, wo, bqkv, None, bias, ctx, lse, g, num_heads, scale, None)
    return layer_norm_bwd(dx, xhat, rstd, gb[0]).to(dx.dtype)


@torch.library.custom_op(
    "feddat_tpu_torch::attn_block_fwd", mutates_args=(),
    schema="(Tensor x, Tensor wq, Tensor wk, Tensor wv, Tensor wo, Tensor bqkv, Tensor bo, "
           "Tensor? gb, Tensor? bias, int num_heads, float? scale, float? ln_eps) "
           "-> (Tensor, Tensor, Tensor)")
def attn_block_fwd(x, wq, wk, wv, wo, bqkv, bo, gb, bias, num_heads, scale, ln_eps):
    """-> (out, ctx, lse): kernel #1 for a CUDA tensor, the plain version for a
    CPU tensor, as one dispatcher op, so that a remat policy sees it and can
    keep its outputs instead of launching it again in the backward."""
    impl = attn_block_cuda if x.is_cuda else attn_block_reference
    return impl(x, wq, wk, wv, wo, bqkv, bo, gb, bias, num_heads, scale, ln_eps)


class _AttnBlock(torch.autograd.Function):
    """The JAX custom_vjp's contract (attn_block.py:314-422): ``dx`` is
    real; the weights, biases, LN parameters and the mask get none.  The
    forward's three outputs are the remat targets ``attn_out``, ``attn_ctx``
    and ``attn_lse`` (attn_block.py:341-349, layers.py:259)."""

    @staticmethod
    def forward(ctx, x, wq, wk, wv, wo, bqkv, bo, gb, bias, num_heads, scale, ln_eps):
        with checkpoint_name("attn_out", "attn_ctx", "attn_lse"):
            out, ctx_t, lse = attn_block_fwd(x, wq, wk, wv, wo, bqkv, bo, gb, bias, num_heads,
                                             scale, ln_eps)
        ctx.save_for_backward(x, wq, wk, wv, wo, bqkv, gb, bias, ctx_t, lse)
        ctx.cfg = (num_heads, scale, ln_eps)
        return out

    @staticmethod
    def backward(ctx, g):
        x, wq, wk, wv, wo, bqkv, gb, bias, ctx_t, lse = ctx.saved_tensors
        dx = None
        if ctx.needs_input_grad[0]:
            dx = attn_block_bwd(x, wq, wk, wv, wo, bqkv, gb, bias, ctx_t, lse,
                                g.contiguous(), *ctx.cfg)
        return (dx,) + (None,) * 11


def attn_block(x, wq, wk, wv, wo, bqkv, bo, gb, bias, num_heads: int,
               scale: Optional[float] = None, ln_eps: Optional[float] = None) -> torch.Tensor:
    """The attention block's output ``[B, S, Dm]``, differentiable in ``x``:
    the CUDA kernels for a CUDA tensor, the plain versions for a CPU tensor
    (never a fallback)."""
    return _AttnBlock.apply(x, wq, wk, wv, wo, bqkv, bo, gb, bias, num_heads, scale, ln_eps)
