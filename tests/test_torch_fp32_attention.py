"""The "fused" and "flash" routes in float32: kernels #5-#9 against the JAX package.

* JAX's ``fused_short_attention`` (#5/#6) and ``flash_attention`` (#7-#9) in
  float32 (their Pallas kernels in interpret mode, as
  tests/test_pallas_kernels.py runs them) against the port's plain versions
  through their autograd wrappers, at the card's head dim 64: o, and dq, dk,
  dv against ``jax.vjp``, at every bias layout flash takes (none, a key row,
  causal + padding, packed block-diagonal, per head).  Forward at
  rtol=atol=2e-5, gradients at rtol=1e-4, atol=2e-5, as
  tests/test_torch_fp32_routes.py holds the float32 "layer" route.
* ``chip_smoke.py``'s float64 evaluation (``float64_mode``, ``to_float64``) of
  the five plain versions gives float64 outputs within fp32 rounding of the
  fp32 ones; in float32 the rounding points of #5/#6's plain versions
  (bf16(P), bf16(ds)) are no-ops, so they are #7-#9's function bit for bit.
* The wrappers' dtype check (``fused_attention.check_dtypes``, which reads
  dtypes only) on CPU tensors: bf16 and float32 pass, float16, float64 and
  mixed dtypes raise ``TypeError`` naming the operand, before any launch.
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feddat_tpu.ops import attention as jattention
from feddat_tpu.ops import flash as jflash
from feddat_tpu.ops import fused_attention as jfused
from feddat_tpu_torch.ops import flash as fl
from feddat_tpu_torch.ops import fused_attention as fa

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

D = 64
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=2e-5)


def _bias(rng, kind, b, h, sq, skv):
    """The compact float32 bias of one layout (None for "none")."""
    if kind == "none":
        return None
    if kind == "key":  # [B,1,1,Skv] padding: text self-attention, every cross site
        mask = (rng.rand(b, skv) > 0.3).astype(np.float32)
        mask[:, 0] = 1.0
        return ((1.0 - mask) * -10000.0)[:, None, None, :].astype(np.float32)
    if kind == "causal":  # [B,1,Sq,Skv] padding + causal: the training decoder
        mask = np.ones((b, skv), np.float32)
        mask[0, skv - 2:] = 0.0
        key = np.asarray(jattention.mask_to_bias(jnp.asarray(mask)))
        return (key + np.asarray(jattention.causal_bias(skv))).astype(np.float32)
    if kind == "packed":  # [G,1,gL,gL] block diagonal: the packed rerank decoder
        mask = np.ones((b * 3, sq // 3), np.float32)
        mask[1, -1] = 0.0
        return np.asarray(jattention.packed_self_bias(jnp.asarray(mask), 3, True))
    if kind == "heads":  # [1,H,Sq,Skv]: the head-dim layout
        return rng.randn(1, h, sq, skv).astype(np.float32)
    raise ValueError(kind)


def _inputs(seed, b, h, sq, skv, kind):
    rng = np.random.RandomState(seed)
    q, g = (rng.randn(b, h, sq, D).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, h, skv, D).astype(np.float32) for _ in range(2))
    return q, k, v, g, _bias(rng, kind, b, h, sq, skv)


def _torch(arrays):
    return [None if a is None else torch.from_numpy(np.array(a)) for a in arrays]


def _against_jax(jax_fn, torch_fn, q, k, v, g, bias):
    """o and the three gradients of ``torch_fn`` (the port's autograd wrapper
    on CPU tensors: the plain versions) against ``jax.vjp`` of ``jax_fn``."""
    jbias = None if bias is None else jnp.asarray(bias)
    out_j, vjp = jax.vjp(lambda a, b_, c: jax_fn(a, b_, c, jbias, None, True),
                         *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(g))
    tq, tk, tv, tg, tbias = _torch((q, k, v, g, bias))
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = torch_fn(*leaves, tbias)
    got = torch.autograd.grad(out, leaves, tg)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **FWD_TOL, err_msg="o")
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("kind,b,s", [("none", 2, 21), ("key", 2, 21), ("key", 1, 65)])
def test_fused_matches_jax_in_float32(kind, b, s):
    """#5/#6's plain versions through ``fused_short_attention``; the JAX side
    is its custom_vjp over both Pallas kernels."""
    q, k, v, g, bias = _inputs(s + b, b, 2, s, s, kind)
    _against_jax(jfused.fused_short_attention, fa.fused_short_attention, q, k, v, g, bias)


@pytest.mark.parametrize("kind,sq,skv", [
    ("none", 37, 37),  # the ViT's self-attention
    ("key", 9, 37),  # a cross site: a staged key row
    ("causal", 10, 10),  # the training decoder: a [query][key] tile
    ("packed", 12, 12),  # the rerank decoder's block-diagonal tile
    ("heads", 19, 13),  # a per-head tile
])
def test_flash_matches_jax_in_float32(kind, sq, skv):
    """#7-#9's plain versions through ``flash_attention``; the JAX side is its
    custom_vjp over the three Pallas kernels."""
    q, k, v, g, bias = _inputs(sq + 3 * skv, 2, 2, sq, skv, kind)
    _against_jax(jflash.flash_attention, fl.flash_attention, q, k, v, g, bias)


def _plain_calls(kind):
    """The five plain versions on one case -> (name, function, float32 args)."""
    q, k, v, g, bias = _torch(_inputs(7, 2, 2, 13, 13, kind))
    scale = D ** -0.5
    fo, flse = fa.fused_attention_fwd_ref(q, k, v, bias, scale)
    o, lse = fl.flash_attention_fwd_ref(q, k, v, bias, scale)
    return [("fused_attention_fwd_ref", fa.fused_attention_fwd_ref, (q, k, v, bias, scale)),
            ("fused_attention_bwd_ref", fa.fused_attention_bwd_ref, (q, k, v, bias, fo, g, flse, scale)),
            ("flash_attention_fwd_ref", fl.flash_attention_fwd_ref, (q, k, v, bias, scale)),
            ("flash_attention_bwd_ref", fl.flash_attention_bwd_ref, (q, k, v, bias, o, g, lse, scale))]


@pytest.mark.parametrize("index", range(4), ids=[c[0] for c in _plain_calls("key")])
def test_chip_smoke_float64_evaluation_of_the_plain_versions(index):
    """``float64_mode`` runs a plain version in float64 (its fp32 casts taken
    to float64): every output is float64 and within fp32 rounding of the
    float32 one.  (The flash backward is #8 and #9 together.)"""
    _, fn, args = _plain_calls("key")[index]
    want = fn(*args)
    with chip_smoke.float64_mode(torch):
        exact = fn(*chip_smoke.to_float64(torch, args))
    for k, r in zip(exact, want):
        assert k.dtype == torch.float64 and r.dtype == torch.float32
        np.testing.assert_allclose(k.numpy(), r.double().numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["none", "key"])
def test_fused_rounding_points_are_no_ops_in_float32(kind):
    """In float32, #5's bf16(P) and #6's bf16(ds) are casts to float32: the
    plain #5/#6 are the plain #7/#8/#9 (which never round P or ds) bit for
    bit, on the padding biases #5 takes (the scale, 2^-3, is exact)."""
    q, k, v, g, bias = _torch(_inputs(11, 2, 2, 21, 21, kind))
    scale = D ** -0.5
    fused, flash = fa.fused_attention_fwd_ref(q, k, v, bias, scale), fl.flash_attention_fwd_ref(q, k, v, bias, scale)
    for a, b in zip(fused, flash):
        assert torch.equal(a, b)
    o, lse = fused
    for a, b in zip(fa.fused_attention_bwd_ref(q, k, v, bias, o, g, lse, scale),
                    fl.flash_attention_bwd_ref(q, k, v, bias, o, g, lse, scale)):
        assert torch.equal(a, b)


def _heads(dtype):
    return torch.zeros(1, 2, 4, D, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dtype_check_takes_bf16_and_float32(dtype):
    t = _heads(dtype)
    ops = (("q", t), ("k", t), ("v", t), ("o", t), ("do", t))
    assert fa.check_dtypes("fn", ops) == dtype
    out = fa._empty_heads(2, 3, 5, "cpu", dtype)
    assert out.dtype == dtype and out.shape == (2, 3, 5, D) and out.stride() == (3 * 5 * D, D, 3 * D, 1)


@pytest.mark.parametrize("operands,message", [
    ({"q": torch.float16}, "q must be torch.bfloat16 or torch.float32, got torch.float16"),
    ({"q": torch.float64}, "q must be torch.bfloat16 or torch.float32, got torch.float64"),
    ({"k": torch.bfloat16}, "k must be q's torch.float32, got torch.bfloat16"),
    ({"v": torch.float64}, "v must be torch.bfloat16 or torch.float32, got torch.float64"),
    ({"do": torch.bfloat16}, "do must be q's torch.float32, got torch.bfloat16"),
])
def test_dtype_check_refuses_other_and_mixed_dtypes(operands, message):
    """float32 operands with the named ones of another dtype: ``TypeError``
    naming the first operand that is off, from the dtypes alone; the CUDA
    wrappers raise it before they look at the device or launch anything."""
    ts = {n: _heads(operands.get(n, torch.float32)) for n in ("q", "k", "v", "o", "do")}
    with pytest.raises(TypeError, match=message):
        fa.check_dtypes("fn", tuple(ts.items()))
    lse = torch.zeros(1, 2, 4)
    before = [kern.launches for kern in (fa.KERNEL, fa.KERNEL_BWD, fl.KERNEL, fl.KERNEL_BWD_DQ,
                                         fl.KERNEL_BWD_DKV)]
    q, k, v, o, do = ts.values()
    if "do" not in operands:
        with pytest.raises(TypeError, match=message):
            fa.fused_attention_fwd_cuda(q, k, v, None, 0.125)
        with pytest.raises(TypeError, match=message):
            fl.flash_attention_fwd_cuda(q, k, v, None, 0.125)
    with pytest.raises(TypeError, match=message):
        fa.fused_attention_bwd_cuda(q, k, v, None, o, do, lse, 0.125)
    with pytest.raises(TypeError, match=message):
        fl.flash_attention_bwd_cuda(q, k, v, None, o, do, lse, 0.125)
    assert [kern.launches for kern in (fa.KERNEL, fa.KERNEL_BWD, fl.KERNEL, fl.KERNEL_BWD_DQ,
                                       fl.KERNEL_BWD_DKV)] == before
