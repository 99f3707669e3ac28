"""Whole pre-LN transformer layer with an adapter site, with a one-kernel backward.

Counterpart of ``feddat_tpu/ops/layer_block.py``::

    h   = x + attn_block(x)          (LN1 fused into the attention kernel)
    m   = LayerNorm2(h)
    f   = gelu(m · W1ᵀ + b1) · W2ᵀ + b2
    o   = h + f
    out = o + w_a·ad_a(o) [+ w_b·ad_b(o)]     (single adapter, or the ensemble)

* :func:`layer_fwd` — ``_layer_fwd_impl``: the attention through kernel #1
  (with LN1 fused up to ``LN_FWD_FUSED_MAX_S``, outside past it), the rest in
  plain ops; returns ``out`` and the residuals ``(x, ctx, lse, aout)``.
* :func:`layer_block_bwd_reference` — the plain version of
  ``_layer_bwd_kernel`` (kernel #4) with its rounding points.
* :func:`layer_block_bwd_cuda` — the hand-written kernel in
  ``csrc/layer_block.cu`` (its attention part is ``csrc/attn_bwd.cuh``), in
  bf16 or float32 (the model's dtype), at any adapter bottleneck and width:
  the wrapper zero-pads the adapters to :func:`padded_bottleneck` and
  :func:`padded_width` and drops the padded gradients.
* :func:`layer_block` — the autograd wrapper with the JAX contract: real
  gradients for ``x`` and the active adapter's ``wd, bd, wu, bu``; none for
  the frozen backbone and the ensemble partner.  The adapter weight
  gradients come back in the weight's dtype (``dwda.astype(wda.dtype)``,
  layer_block.py:497-498), the bias gradients in the bias's.

Backbone weights use the ``nn.Linear`` layout ``[out, in]`` (``w1 [F, Dm]``,
``w2 [Dm, F]``); the adapters the flax layout of the JAX function
(``wd [Dm, r]``, ``wu [r, Dm]``); biases and LN parameters are fp32 rows
(``bqkv [3, Dm]``, ``bo``/``b2``/``bu [1, Dm]``, ``b1 [1, F]``, ``bd [1, r]``,
``gb1``/``gb2 [2, Dm]``).  A CPU tensor takes the plain versions, a CUDA
tensor launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from feddat_tpu_torch.ops._build import CudaKernel, load, ptr
from feddat_tpu_torch.ops.attn_block import (
    _key_bias,
    attn_block_cuda,
    attn_block_reference,
    attn_bwd_core_reference,
    check_cuda_arg,
    check_heads,
    kernel_dtype,
    layer_norm_bwd,
    layer_norm_fast_variance,
    layer_norm_stats,
)

_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = CudaKernel(
    "layer_block", "layer_block_bwd",
    [_vp] * 31 + [_i] * 7 + [_f] * 5 + [_i, _vp],
)
# Longest S at which the forward keeps LN1 fused into kernel #1 (layer_block.py:66).
LN_FWD_FUSED_MAX_S = 448
SQRT_2 = 1.4142135623730951
INV_SQRT_2PI = 0.3989422804014327
# The TPU kernel's erf polynomial (layer_block.py:92-113): odd numerator, even denominator.
_ERF_NUM = (-2.72614225801306e-10, 2.77068142495902e-08, -2.10102402082508e-06,
            -5.69250639462346e-05, -7.34990630326855e-04, -2.95459980854025e-03,
            -1.60960333262415e-02)
_ERF_DEN = (-1.45660718464996e-05, -2.13374055278905e-04, -1.68282697438203e-03,
            -7.37332916720468e-03, -1.42647390514189e-02)


def erf_poly(x: torch.Tensor) -> torch.Tensor:
    """fp32 erf as the TPU kernel computes it (max abs error 6.0e-7)."""
    x = torch.clamp(x, -4.0, 4.0)
    x2 = x * x
    a = torch.full_like(x, _ERF_NUM[0])
    for c in _ERF_NUM[1:]:
        a = a * x2 + c
    a = a * x
    b = torch.full_like(x, _ERF_DEN[0])
    for c in _ERF_DEN[1:]:
        b = b * x2 + c
    return a / b


def gelu_poly(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + erf_poly(x * (1.0 / SQRT_2)))


def gelu_grad_poly(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + erf_poly(x * (1.0 / SQRT_2))) + x * torch.exp(-0.5 * x * x) * INV_SQRT_2PI


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x / SQRT_2))


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with fp32 accumulation and an fp32 result, as
    ``jnp.dot(..., preferred_element_type=jnp.float32)``: bf16 operands stay
    bf16 on the card (cuBLAS with an fp32 output) and are upcast on the CPU."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        flat = a.reshape(-1, a.shape[-1])
        return torch.mm(flat, b, out_dtype=torch.float32).reshape(*a.shape[:-1], b.shape[-1])
    return a.to(torch.float32) @ b.to(torch.float32)


def layer_fwd(x, wq, wk, wv, wo, bqkv, bo, gb1, gb2, w1, b1, w2, b2,
              wda, bda, wua, bua, wdb, bdb, wub, bub, bias,
              num_heads: int, scale: Optional[float], ln_eps1: float, ln_eps2: float,
              w_a: float, w_b: float, use_b: bool):
    """``_layer_fwd_impl`` -> ``(out, (x, ctx, lse, aout))``."""
    dt = x.dtype
    attn = attn_block_cuda if x.is_cuda else attn_block_reference
    if x.shape[1] <= LN_FWD_FUSED_MAX_S:
        aout, ctx, lse = attn(x, wq, wk, wv, wo, bqkv, bo, gb1, bias, num_heads, scale, ln_eps1)
    else:  # LN1 outside, the plain forward kernel (layer_block.py:357-376)
        xln = layer_norm_fast_variance(x, gb1[0], gb1[1], ln_eps1).to(dt)
        aout, ctx, lse = attn(xln, wq, wk, wv, wo, bqkv, bo, None, bias, num_heads, scale, None)
    h = x + aout
    m = layer_norm_fast_variance(h, gb2[0], gb2[1], ln_eps2).to(dt)
    p1 = mm_f32(m, w1.t()) + b1[0]
    f = mm_f32(gelu_exact(p1).to(dt), w2.t()) + b2[0]
    o = h + f.to(dt)

    def delta(wd, bd, wu, bu):
        down = mm_f32(o, wd.to(dt)) + bd[0]
        return mm_f32(torch.relu(down).to(dt), wu.to(dt)) + bu[0]

    d_total = w_a * delta(wda, bda, wua, bua)
    if use_b:
        d_total = d_total + w_b * delta(wdb, bdb, wub, bub)
    return o + d_total.to(dt), (x, ctx, lse, aout)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def ffn_recompute_reference(x, aout, gb2, w1, b1, w2, b2, ln_eps2: float):
    """Steps 1-2 of kernel #4, plain: ``h = x + aout``, LN2 and the FFN
    recomputed -> ``(h, xhat2, rstd2, p1, o)``; ``h`` and ``o`` in
    ``x.dtype``, the LN2 statistics and ``p1`` fp32."""
    dt = x.dtype
    h = (_f32(x) + _f32(aout)).to(dt)
    xhat2, rstd2 = layer_norm_stats(h, ln_eps2)
    m = (xhat2 * gb2[0] + gb2[1]).to(dt)
    p1 = _f32(m) @ _f32(w1).t() + b1[0]
    f = (_f32(gelu_poly(p1).to(dt)) @ _f32(w2).t() + b2[0]).to(dt)
    return h, xhat2, rstd2, p1, (_f32(h) + _f32(f)).to(dt)


def adapter_bwd_reference(o, g, wd, bd, wu, w: float, gate: Optional[torch.Tensor] = None):
    """One adapter's backward at the layer output ``o`` (step 3), plain ->
    ``(relu, g_delta, g_down)``: ``relu = max(down, 0)`` and ``g_delta =
    g·w`` in ``o.dtype``, ``g_down`` fp32.  ``gate`` (bool, shaped like
    ``down``) stands in for ``down > 0``: ``chip_smoke.py`` passes the
    kernel's own gate, so that its weight gradients are held free of gate
    flips where ``down`` is within rounding noise of 0."""
    dt = o.dtype
    down = _f32(o) @ _f32(wd) + bd[0]
    if gate is None:
        gate = down > 0.0
    zero = torch.zeros((), dtype=torch.float32, device=o.device)
    g_delta = (_f32(g) * w).to(dt)
    g_down = torch.where(gate, _f32(g_delta) @ _f32(wu).t(), zero)
    return torch.where(gate, down, zero).to(dt), g_delta, g_down


def adapter_wgrads_reference(o, relu, g_delta, g_down):
    """The active adapter's gradients summed over all rows -> ``(dwd [Dm, r],
    dbd [r], dwu [r, Dm], dbu [Dm])``, fp32: ``dbd`` sums the fp32
    ``g_down``, ``dbu`` the ``o.dtype`` ``g_delta``."""
    def rows(t):
        return _f32(t.reshape(-1, t.shape[-1]))

    g_down_r = rows(g_down.to(o.dtype))
    return (rows(o).t() @ g_down_r, rows(g_down).sum(0),
            rows(relu).t() @ rows(g_delta), rows(g_delta).sum(0))


def layer_tail_bwd_reference(g_o, xhat2, rstd2, p1, x, ctx, lse, bias, wq, wk, wv, wo, bqkv,
                             gb1, gb2, w1, w2, num_heads: int, scale: Optional[float],
                             ln_eps1: float):
    """Steps 4-7 of kernel #4, plain: from ``g_o`` (fp32 d o) through the
    FFN, LN2, the attention and LN1 to ``dx`` in ``x.dtype``."""
    dt = x.dtype
    b, s, dm = x.shape
    if scale is None:
        scale = (dm // num_heads) ** -0.5
    g_p1 = ((_f32(g_o.to(dt)) @ _f32(w2)) * gelu_grad_poly(p1)).to(dt)
    g_h = g_o + layer_norm_bwd(_f32(g_p1) @ _f32(w1), xhat2, rstd2, gb2[0])
    # attention backward with LN1 re-derived from x
    xhat1, rstd1 = layer_norm_stats(x, ln_eps1)
    xb = (xhat1 * gb1[0] + gb1[1]).to(dt)
    dxln = attn_bwd_core_reference(xb, wq, wk, wv, wo, bqkv, _key_bias(bias, b, s), ctx, lse,
                                   g_h.to(dt), num_heads, scale)
    return (layer_norm_bwd(dxln, xhat1, rstd1, gb1[0]) + g_h).to(dt)


def layer_block_bwd_reference(x, aout, ctx, lse, g, bias, wq, wk, wv, wo, bqkv, gb1, gb2,
                              w1, b1, w2, b2, wda, bda, wua, bua, wdb, bdb, wub, bub,
                              num_heads: int, scale: Optional[float], ln_eps1: float,
                              ln_eps2: float, w_a: float, w_b: float, use_b: bool):
    """Plain version of kernel #4 -> ``(dx, dwda, dbda, dwua, dbua)``:
    ``dx`` in ``x.dtype``, the adapter gradients fp32 (``dwda [Dm, r]``,
    ``dbda [r]``, ``dwua [r, Dm]``, ``dbua [Dm]``).  Rounds where
    ``_layer_bwd_kernel`` rounds (layer_block.py:163-302), in the kernel's
    stages: the FFN recompute, the adapters, then the tail to ``dx``."""
    dt = x.dtype
    _, xhat2, rstd2, p1, o = ffn_recompute_reference(x, aout, gb2, w1, b1, w2, b2, ln_eps2)
    # real grads for the active adapter; the frozen partner contributes to d o only
    relu_a, g_delta_a, g_down_a = adapter_bwd_reference(o, g, wda, bda, wua, w_a)
    g_o = _f32(g) + _f32(g_down_a.to(dt)) @ _f32(wda).t()
    if use_b:
        g_down_b = adapter_bwd_reference(o, g, wdb, bdb, wub, w_b)[2]
        g_o = g_o + _f32(g_down_b.to(dt)) @ _f32(wdb).t()
    dx = layer_tail_bwd_reference(g_o, xhat2, rstd2, p1, x, ctx, lse, bias, wq, wk, wv, wo, bqkv,
                                  gb1, gb2, w1, w2, num_heads, scale, ln_eps1)
    return (dx, *adapter_wgrads_reference(o, relu_a, g_delta_a, g_down_a))


@functools.cache
def _workspace(b: int, s: int, dm: int, h: int, f: int, r: int, f32: int) -> int:
    fn = load("layer_block").layer_block_bwd_workspace
    fn.argtypes, fn.restype = [_i] * 7, ctypes.c_longlong
    return fn(b, s, dm, h, f, r, f32)


def padded_bottleneck(r: int, f32: bool) -> int:
    """The bottleneck #4 runs for adapter bottleneck ``r >= 1``: as few
    chunks as take at most 64 columns each (16 in float32), all of one width
    that is a multiple of 16 (``layer_block_padded_bottleneck`` in
    csrc/layer_block.cu, which ``chip_smoke.py`` holds this against).  The
    wrapper zero-pads the adapters to it: a padded down column gives
    ``relu(0) = 0`` and a closed gate, so it changes nothing."""
    most = 16 if f32 else 64
    n = -(-r // most)
    return n * (-(-(-(-r // n)) // 16) * 16)


def layer_block_bwd_cuda(*args):
    """Kernel #4 -> ``(dx, dwda, dbda, dwua, dbua)``, as
    :func:`layer_block_bwd_reference` (same arguments).  Activations, weights
    and adapters in bf16 or float32 (one type), fp32 biases/LN rows; any
    ``Dm`` that divides into heads of 1 to 256, any ``F``, any bottleneck,
    any S >= 1.
    Deterministic: the adapter gradients are summed in a fixed order.
    Raises on anything else."""
    return _bwd_cuda(*args)[0]


# What layer_block_bwd leaves in its workspace, in the order of
# layer_block_bwd_stage_offsets: (name, in x's type (else fp32)?, row width).
_STAGES = (("h", True, "dm"), ("m", True, "dm"), ("o", True, "dm"), ("p1", False, "ff"),
           ("relu_a", True, "r"), ("g_down_a", False, "r"), ("g_o", False, "dm"))


@functools.cache
def _stage_offsets(b: int, s: int, dm: int, h: int, f: int, r: int, f32: int):
    fn = load("layer_block").layer_block_bwd_stage_offsets
    fn.argtypes, fn.restype = [_i] * 7 + [ctypes.POINTER(ctypes.c_longlong)], None
    out = (ctypes.c_longlong * len(_STAGES))()
    fn(b, s, dm, h, f, r, f32, out)
    return tuple(out)


def layer_block_bwd_cuda_stages(*args):
    """:func:`layer_block_bwd_cuda` -> ``(outputs, stages)``, where
    ``stages`` views the kernel's own intermediates, each ``[B·S, width]``:
    ``h``, ``m``, ``o`` (in ``x``'s type), ``p1`` (fp32), the active
    adapter's ``relu_a`` (``x``'s type) and ``g_down_a`` (fp32), and ``g_o``
    (fp32); ``relu_a`` and ``g_down_a`` at the padded bottleneck, the
    adapter's own columns first.  ``chip_smoke.py`` holds each stage of the
    kernel against the plain one."""
    outs, ws = _bwd_cuda(*args)
    x, num_heads, w1, wda = args[0], args[25], args[13], args[17]
    (b, s, dm), ff = x.shape, w1.shape[0]
    f32 = int(x.dtype == torch.float32)
    r = padded_bottleneck(wda.shape[1], bool(f32))
    widths, stages = {"dm": dm, "ff": ff, "r": r}, {}
    for (name, own, width), off in zip(_STAGES, _stage_offsets(b, s, dm, num_heads, ff, r, f32)):
        dtype = x.dtype if own else torch.float32
        n = b * s * widths[width] * dtype.itemsize
        stages[name] = ws[off:off + n].view(dtype).view(b * s, widths[width])
    return outs, stages


def padded_width(dm: int) -> int:
    """The width kernel #4's adapter kernels run at: ``dm`` rounded up to a
    multiple of 128 (csrc/layer_block.cu ``layer_block_padded_width``; the
    layer's other passes take ``dm`` as it is)."""
    return -(-dm // 128) * 128


def _pad_adapter(wd, bd, wu, rp: int, dw: Optional[int] = None):
    """One adapter's ``(wd [Dm, r], bd [1, r], wu [r, Dm])`` zero-padded to
    bottleneck ``rp`` and width ``dw`` (default Dm), with ``wd`` transposed
    beside it: ``(wd, bd, wu, wdᵀ)``, contiguous (the row pass reads the down
    kernel along both axes)."""
    pad, wpad = rp - wd.shape[1], (dw or wd.shape[0]) - wd.shape[0]
    if pad or wpad:
        wd = torch.nn.functional.pad(wd, (0, pad, 0, wpad))
        bd = torch.nn.functional.pad(bd, (0, pad))
        wu = torch.nn.functional.pad(wu, (0, wpad, 0, pad))
    return wd.contiguous(), bd.contiguous(), wu.contiguous(), wd.t().contiguous()


def _bwd_cuda(x, aout, ctx, lse, g, bias, wq, wk, wv, wo, bqkv, gb1, gb2,
              w1, b1, w2, b2, wda, bda, wua, bua, wdb, bdb, wub, bub,
              num_heads: int, scale: Optional[float], ln_eps1: float,
              ln_eps2: float, w_a: float, w_b: float, use_b: bool):
    """Launch kernel #4 -> ``((dx, dwda, dbda, dwua, dbua), workspace)``."""
    fn = "layer_block_bwd_cuda"
    if x.dim() != 3:
        raise ValueError(f"{fn}: x must be [B, S, Dm], got {tuple(x.shape)}")
    b, s, dm = x.shape
    check_heads(fn, dm, num_heads)
    ff, r = w1.shape[0], wda.shape[1]
    bf, f32 = kernel_dtype(fn, x), torch.float32
    act = (b, s, dm)
    for name, t, dtype, shape in (
        ("x", x, bf, act), ("aout", aout, bf, act), ("ctx", ctx, bf, act), ("g", g, bf, act),
        ("lse", lse, f32, (b, num_heads, s)),
        ("wq", wq, bf, (dm, dm)), ("wk", wk, bf, (dm, dm)), ("wv", wv, bf, (dm, dm)),
        ("wo", wo, bf, (dm, dm)), ("bqkv", bqkv, f32, (3, dm)), ("gb1", gb1, f32, (2, dm)),
        ("gb2", gb2, f32, (2, dm)), ("w1", w1, bf, (ff, dm)), ("b1", b1, f32, (1, ff)),
        ("w2", w2, bf, (dm, ff)), ("b2", b2, f32, (1, dm)),
        ("wda", wda, bf, (dm, r)), ("bda", bda, f32, (1, r)), ("wua", wua, bf, (r, dm)),
        ("wdb", wdb, bf, (dm, r)), ("bdb", bdb, f32, (1, r)), ("wub", wub, bf, (r, dm)),
    ):
        check_cuda_arg(fn, name, t, dtype, shape)
    if ff < 1 or r < 1:
        raise ValueError(f"{fn}: FFN width {ff} and bottleneck {r} must be at least 1")
    brow = _key_bias(bias, b, s)
    if brow is not None:
        brow = brow.contiguous()
        check_cuda_arg(fn, "bias", brow, f32, (b, s))
    if s < 1:
        raise ValueError(f"{fn}: x holds no tokens (S = {s})")
    if scale is None:
        scale = (dm // num_heads) ** -0.5
    is_f32 = int(bf == f32)
    rp, dw = padded_bottleneck(r, bool(is_f32)), padded_width(dm)
    wda, bda, wua, wda_t = _pad_adapter(wda, bda, wua, rp, dw)
    wdb, bdb, wub, wdb_t = _pad_adapter(wdb, bdb, wub, rp, dw)
    dev = x.device
    ws = torch.empty(_workspace(b, s, dm, num_heads, ff, rp, is_f32), dtype=torch.uint8, device=dev)
    dx = torch.empty_like(x)
    dwda = torch.empty((dw, rp), dtype=f32, device=dev)
    dbda = torch.empty((rp,), dtype=f32, device=dev)
    dwua = torch.empty((rp, dw), dtype=f32, device=dev)
    dbua = torch.empty((dw,), dtype=f32, device=dev)
    KERNEL.launch(
        ptr(x), ptr(aout), ptr(ctx), ptr(lse), ptr(g), ptr(brow),
        ptr(wq), ptr(wk), ptr(wv), ptr(wo), ptr(bqkv), ptr(gb1), ptr(gb2),
        ptr(w1), ptr(b1), ptr(w2), ptr(b2),
        ptr(wda), ptr(bda), ptr(wua), ptr(wda_t), ptr(wdb), ptr(bdb), ptr(wub), ptr(wdb_t),
        ptr(ws), ptr(dx), ptr(dwda), ptr(dbda), ptr(dwua), ptr(dbua),
        b, s, dm, num_heads, ff, rp, is_f32, float(scale), float(ln_eps1), float(ln_eps2),
        float(w_a), float(w_b), int(bool(use_b)),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rp != r or dw != dm:  # the padded rows' and columns' gradients are dropped
        dwda, dbda = dwda[:dm, :r].contiguous(), dbda[:r].contiguous()
        dwua, dbua = dwua[:r, :dm].contiguous(), dbua[:dm].contiguous()
    return (dx, dwda, dbda, dwua, dbua), ws


class _LayerBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wq, wk, wv, wo, bqkv, bo, gb1, gb2, w1, b1, w2, b2,
                wda, bda, wua, bua, wdb, bdb, wub, bub, bias, cfg):
        out, (_, ctx_t, lse, aout) = layer_fwd(
            x, wq, wk, wv, wo, bqkv, bo, gb1, gb2, w1, b1, w2, b2,
            wda, bda, wua, bua, wdb, bdb, wub, bub, bias, *cfg)
        ctx.save_for_backward(x, aout, ctx_t, lse, bias, wq, wk, wv, wo, bqkv, gb1, gb2,
                              w1, b1, w2, b2, wda, bda, wua, bua, wdb, bdb, wub, bub)
        ctx.cfg = cfg
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        x, wda, bda, wua, bua = saved[0], *saved[16:20]
        impl = layer_block_bwd_cuda if x.is_cuda else layer_block_bwd_reference
        dx, dwda, dbda, dwua, dbua = impl(*saved[:4], g.contiguous(), *saved[4:], *ctx.cfg)
        # x, 12 frozen backbone tensors, the active adapter, the partner, bias, cfg
        return (dx, *(None,) * 12,
                dwda.to(wda.dtype), dbda.to(bda.dtype)[None, :],
                dwua.to(wua.dtype), dbua.to(bua.dtype)[None, :],
                None, None, None, None, None, None)


def layer_block(x, wq, wk, wv, wo, bqkv, bo, gb1, gb2, w1, b1, w2, b2,
                wda, bda, wua, bua, wdb, bdb, wub, bub, bias,
                num_heads: int, scale: Optional[float], ln_eps1: float, ln_eps2: float,
                w_a: float, w_b: float, use_b: bool) -> torch.Tensor:
    """The whole layer's output ``[B, S, Dm]`` (see the module docstring).
    ``w_a``/``w_b``: the active adapter's and the frozen partner's forward
    scaling (single mode: ``w_a=1, use_b=False``; DAT ensemble:
    ``ensemble_weight·scaling`` and ``(1−ensemble_weight)·scaling``)."""
    cfg = (num_heads, scale, float(ln_eps1), float(ln_eps2), float(w_a), float(w_b), bool(use_b))
    return _LayerBlock.apply(x, wq, wk, wv, wo, bqkv, bo, gb1, gb2, w1, b1, w2, b2,
                             wda, bda, wua, bua, wdb, bdb, wub, bub, bias, cfg)
