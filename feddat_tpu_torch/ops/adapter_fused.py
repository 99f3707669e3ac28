"""Fused DAT ensemble-adapter epilogue.

Counterpart of ``feddat_tpu/ops/adapter_fused.py``::

    delta = w·up_a(relu(down_a h)) + (1−w)·up_b(relu(down_b h))     (fp32 math)

returned in ``h.dtype``; the caller adds the residual and the adapter
scaling.  ``params_*`` = ``(w_down [d, r], b_down [r], w_up [r, d],
b_up [d])`` in the flax layout, as in the JAX function.

* :func:`adapter_fused_reference` — plain PyTorch, the JAX ``_reference``.
* :func:`adapter_fused_cuda` — the hand-written kernel in
  ``csrc/adapter_fused.cu`` (forward only; wgmma in a 4-CTA cluster; any
  bottleneck, walked in chunks of at most 128 columns (48 in float32), and
  any width that is a multiple of 64; bf16 or float32, the float32 products
  as accurate as fp32's).
* :func:`fused_ensemble_adapter` — the autograd wrapper: forward through the
  kernel for a CUDA tensor (the plain version for a CPU tensor), backward by
  recomputing the plain version, which is the JAX contract
  (``adapter_fused.py:110-113``: its backward is XLA, not Pallas).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from feddat_tpu_torch.ops._build import CudaKernel, load, ptr

KERNEL = CudaKernel(
    "adapter_fused", "adapter_fused_fwd",
    [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p],
)
# The element types the kernel takes (h, the params and the output alike).
DTYPES = (torch.bfloat16, torch.float32)

Params = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def adapter_fused_reference(h: torch.Tensor, params_a: Params, params_b: Params,
                            weight: float) -> torch.Tensor:
    """Plain version: h and the weights taken to fp32, cast back to h.dtype."""
    hf = h.to(torch.float32)

    def branch(wd, bd, wu, bu):
        f = [t.to(torch.float32) for t in (wd, bd, wu, bu)]
        return torch.relu(hf @ f[0] + f[1]) @ f[2] + f[3]

    out = weight * branch(*params_a) + (1.0 - weight) * branch(*params_b)
    return out.to(h.dtype)


# The kernel's shapes: any D >= 1, any R >= 1 and any N.  Each rank of a
# 4-CTA cluster takes D/4 of the K axis and of the output columns, so a D
# that is no multiple of 64 runs at D padded to 64 (zero-padded copies of h
# and the weights in front of the kernel, the output copied back:
# csrc/adapter_fused.cu), as JAX's kernel takes every width.
def takes(d: int, r: int) -> bool:
    """Whether the kernel takes width ``d`` and bottleneck ``r``."""
    return d >= 1 and r >= 1


def padded_width(d: int) -> int:
    """The width the kernel runs at: ``d`` rounded up to 64."""
    return -(-d // 64) * 64


@functools.cache
def _workspace(n: int, d: int, r: int, f32: int) -> int:
    """Bytes of scratch the kernel needs: in float32 the operands' bf16
    terms, and the up projection's fp32 sums between the bottleneck's chunks
    (none for one chunk)."""
    fn = load("adapter_fused").adapter_fused_workspace
    fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_longlong
    return fn(n, d, r, f32)


def adapter_fused_cuda(h: torch.Tensor, params_a: Params, params_b: Params,
                       weight: float) -> torch.Tensor:
    """The CUDA kernel, forward only.  ``h [..., d]`` and the params all in
    bf16 or all in float32, contiguous and 16-byte aligned; any ``d`` and
    ``r``.  Raises on anything else, before any launch."""
    if not h.is_cuda:
        raise ValueError("adapter_fused_cuda: h must be a CUDA tensor")
    d = h.shape[-1]
    r = params_a[0].shape[1]
    shapes = ((d, r), (r,), (r, d), (d,))
    if h.dtype not in DTYPES:
        raise TypeError(f"adapter_fused_cuda takes bf16 or float32 CUDA tensors, got {h.dtype}")
    for t in (h, *params_a, *params_b):
        if not t.is_cuda or t.dtype != h.dtype:
            raise TypeError(f"adapter_fused_cuda takes CUDA tensors of one type ({h.dtype}) only")
        if not t.is_contiguous():
            raise ValueError("adapter_fused_cuda: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("adapter_fused_cuda: inputs must start on a 16-byte boundary")
    for params in (params_a, params_b):
        if tuple(tuple(t.shape) for t in params) != shapes:
            raise ValueError(f"adapter_fused_cuda: params must have shapes {shapes}")
    if not takes(d, r):
        raise ValueError(f"adapter_fused_cuda: width {d} or bottleneck {r} (each at least 1) "
                         f"out of the kernel's range")
    flat = h.reshape(-1, d)
    out = torch.empty_like(flat)
    if flat.shape[0] == 0:
        return out.reshape(h.shape)
    n = flat.shape[0]
    f32 = int(h.dtype == torch.float32)
    size = _workspace(n, d, r, f32)
    ws = torch.empty(size, dtype=torch.uint8, device=h.device) if size else None
    KERNEL.launch(
        ptr(flat), *(ptr(t) for t in params_a), *(ptr(t) for t in params_b), ptr(out), ptr(ws),
        n, d, r, f32, float(weight),
        torch.cuda.current_stream(h.device).cuda_stream,
    )
    return out.reshape(h.shape)


class _FusedEnsembleAdapter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, wda, bda, wua, bua, wdb, bdb, wub, bub, weight):
        pa, pb = (wda, bda, wua, bua), (wdb, bdb, wub, bub)
        ctx.save_for_backward(h, *pa, *pb)
        ctx.weight = weight
        if h.is_cuda:
            return adapter_fused_cuda(h, pa, pb, weight)
        return adapter_fused_reference(h, pa, pb, weight)

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[:9]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
            out = adapter_fused_reference(inputs[0], tuple(inputs[1:5]), tuple(inputs[5:9]),
                                          ctx.weight)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, g) if wanted else ())
        return (*(next(grads) if n else None for n in needs), None)


def fused_ensemble_adapter(h: torch.Tensor, params_a: Sequence[torch.Tensor],
                           params_b: Sequence[torch.Tensor], weight: float = 0.5) -> torch.Tensor:
    """``w·adapter_a(h) + (1−w)·adapter_b(h)`` — the ensemble DELTA."""
    return _FusedEnsembleAdapter.apply(h, *params_a, *params_b, float(weight))
