"""The port's flash attention (``ops/flash.py``) against the JAX Pallas kernels
#7-#9 (``feddat_tpu/ops/flash.py``, interpret mode, as
tests/test_pallas_kernels.py runs them) on the CPU, where the port takes its
plain versions: the forward's o and lse (``_flash_forward``) at every bias
layout ALBEF produces and the head-dim one, with Sq != Skv, Sq = 1 and lengths
that are not multiples of the 128-wide blocks; dq/dk/dv through the autograd
wrapper against ``jax.vjp`` of the custom_vjp; the fp32 P of the P·V product;
and the ``impl="flash"`` route of ``dot_product_attention``.

Tolerances: fp32 rtol=1e-4, atol=1e-5 (the JAX package's own for flash,
tests/test_pallas_kernels.py:26-97: one fp32 function summed in another
order).  bf16: within 2 bf16 ulps of each output's largest magnitude — both
sides round o and the gradients to bf16 once after fp32 sums taken in another
order, so an element may land one rounding apart."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feddat_tpu.ops import attention as jattention
from feddat_tpu.ops import flash as jflash
from feddat_tpu_torch.ops import attention as tattention
from feddat_tpu_torch.ops import flash as fl

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _bias(rng, kind, b, h, sq, skv):
    """The compact layouts of ALBEF's sites (and two more of _prep_bias's)."""
    if kind == "none":
        return None
    if kind == "key":  # [B,1,1,Skv] padding: text self-attention, every cross site
        mask = (rng.rand(b, skv) > 0.3).astype(np.float32)
        mask[:, 0] = 1.0
        return ((1.0 - mask) * -10000.0)[:, None, None, :].astype(np.float32)
    if kind == "causal":  # [B,1,Sq,Skv] padding + causal: the unpacked decoder
        mask = np.ones((b, skv), np.float32)
        mask[0, skv - 2:] = 0.0
        key = np.asarray(jattention.mask_to_bias(jnp.asarray(mask)))
        return (key + np.asarray(jattention.causal_bias(skv))).astype(np.float32)
    if kind == "packed":  # [G,1,gL,gL] block diagonal: the packed stage-2 decoder
        g = 3
        mask = np.ones((b * g, sq // g), np.float32)
        mask[1, -1] = 0.0
        return np.asarray(jattention.packed_self_bias(jnp.asarray(mask), g, True))
    if kind == "all_masked":  # batch 0's keys all carry -10000
        bias = np.zeros((b, 1, 1, skv), np.float32)
        bias[0] = -10000.0
        return bias
    if kind == "heads":  # [1,H,Sq,Skv]: the head-dim layout (no ALBEF site has it)
        return rng.randn(1, h, sq, skv).astype(np.float32)
    if kind == "kv1":  # [B,1,1,1]: a size-1 kv dim, expanded by both sides
        return rng.randn(b, 1, 1, 1).astype(np.float32)
    raise ValueError(kind)


# (name, B, H, Sq, Skv, bias): ALBEF's sites at small widths, then the edges
CASES = [
    ("vit", 2, 2, 37, 37, "none"),
    ("text_self", 2, 2, 9, 9, "key"),
    ("fusion_cross", 2, 2, 9, 37, "key"),
    ("stage1_self", 2, 2, 1, 1, "key"),
    ("stage1_cross", 2, 2, 1, 9, "key"),
    ("decoder_causal", 2, 2, 6, 6, "causal"),
    ("packed_decoder", 2, 2, 12, 12, "packed"),
    ("grouped_cross", 2, 2, 30, 9, "all_masked"),
    ("ragged_long", 1, 2, 130, 140, "key"),
    ("head_bias", 1, 2, 19, 13, "heads"),
    ("kv_dim_1", 2, 2, 5, 7, "kv1"),
    # the CUDA kernels' tile edges (128 query rows per block, 64 keys per
    # streamed tile): each of 127, 128, 129 and 257 on both sides
    ("edge_127", 1, 2, 127, 127, "key"),
    ("edge_128", 1, 2, 128, 257, "heads"),
    ("edge_129", 1, 2, 129, 128, "key"),
    ("edge_257", 1, 2, 257, 129, "heads"),
]


def _inputs(seed, b, h, sq, skv, d, kind):
    rng = np.random.RandomState(seed)
    q, g = (rng.randn(b, h, sq, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, h, skv, d).astype(np.float32) for _ in range(2))
    return q, k, v, g, _bias(rng, kind, b, h, sq, skv)


def _both(arrays, dtype):
    jdt, tdt = DTYPES[dtype]
    return ([None if a is None else jnp.asarray(a, jdt) for a in arrays],
            [None if a is None else torch.from_numpy(a).to(tdt) for a in arrays])


def _check(got, want, dtype, what):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=what)
    else:
        ulp = 2.0 ** (math.floor(math.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * ulp, err_msg=what)


def _jax_forward(jq, jk, jv, jbias, scale):
    b, h, sq, _ = jq.shape
    o, lse = jflash._flash_forward(jq, jk, jv, jbias, scale, interpret=True, need_lse=True)
    return o, np.asarray(lse)[:, :sq].reshape(b, h, sq)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,b,h,sq,skv,kind", CASES)
def test_forward_matches_jax_kernel(name, b, h, sq, skv, kind, dtype):
    d = 16
    seed = 10 * [c[0] for c in CASES].index(name) + list(DTYPES).index(dtype)
    q, k, v, _, bias = _inputs(seed, b, h, sq, skv, d, kind)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), dtype)
    jbias = None if bias is None else jnp.asarray(bias)
    tbias = None if bias is None else torch.from_numpy(bias)
    o_j, lse_j = _jax_forward(jq, jk, jv, jbias, d ** -0.5)
    o_t, lse_t = fl.flash_attention_fwd_ref(tq, tk, tv, tbias, d ** -0.5)
    assert o_t.dtype == DTYPES[dtype][1] and lse_t.dtype == torch.float32
    _check(o_t, o_j, dtype, f"{name} o")
    _check(lse_t, lse_j, dtype, f"{name} lse")
    if kind == "all_masked" and dtype == "float32":
        # every key of batch 0 at -10000: the softmax is shift-invariant, so
        # those rows are the unbiased attention, not dropped or zeroed (up to
        # fp32's spacing at 10^4, 2^-10, which each shifted logit is rounded to)
        free, _ = fl.flash_attention_fwd_ref(tq[:1], tk[:1], tv[:1], None, d ** -0.5)
        np.testing.assert_allclose(o_t[:1].numpy(), free.numpy(), rtol=0, atol=2e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,sq,skv", [
    ("none", 37, 37),  # ALBEF training: ViT self-attention
    ("key", 9, 9),  # text self-attention, padding
    ("key", 9, 37),  # fusion cross-attention
    ("causal", 6, 6),  # decoder self-attention, causal + padding
    ("key", 24, 9),  # decoder grouped cross-attention (A·La -> Lq)
    ("none", 130, 20),  # lengths past the 128-wide blocks
    # the CUDA kernels' tile edges (128 keys per block, 64 queries per
    # streamed tile): each of 127, 128, 129 and 257 on both sides
    ("key", 127, 127),
    ("heads", 257, 128),
    ("key", 128, 129),
    ("heads", 129, 257),
])
def test_grads_match_jax_custom_vjp(kind, sq, skv, dtype):
    """dq/dk/dv of the CPU backward (the plain versions of #8/#9) against
    jax.vjp of the JAX custom_vjp (both Pallas backward kernels, interpret
    mode), at the five layouts of ALBEF's training sites and a ragged one."""
    b, h, d = 2, 2, 16
    q, k, v, g, bias = _inputs(sq + skv, b, h, sq, skv, d, kind)
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _both((q, k, v, g), dtype)
    jbias = None if bias is None else jnp.asarray(bias)
    tbias = None if bias is None else torch.from_numpy(bias)
    out_j, vjp = jax.vjp(lambda a, b_, c: jflash.flash_attention(a, b_, c, jbias, None, True),
                         jq, jk, jv)
    want = vjp(jg)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = fl.flash_attention(*leaves, tbias)
    got = torch.autograd.grad(out, leaves, tg)
    _check(out.detach(), out_j, dtype, "o")
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == DTYPES[dtype][1]
        _check(a, w, dtype, name)


def test_p_stays_fp32_in_p_v():
    """A case where the rounding point of P shows (the one of
    test_torch_fused_attention.py): logits 0 and 2^-10, so p = e^(-2^-10)
    and 1, both 1.0 in bf16, and values +1000 and -1000.  The TPU flash
    kernel keeps P in fp32: o is about -0.49, many bf16 ulps from the 0 that
    a P rounded to bf16 before P·v would give."""
    d = 16
    q, k, v = (np.zeros((1, 1, 2, d), np.float32) for _ in range(3))
    q[..., 0] = 1.0
    k[0, 0, 1, 0] = 2.0 ** -8  # logits q.k/4: 0 and 2^-10
    v[0, 0, 0], v[0, 0, 1] = 1000.0, -1000.0
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), "bfloat16")
    o_j, _ = _jax_forward(jq, jk, jv, None, 0.25)
    o_t, _ = fl.flash_attention_fwd_ref(tq, tk, tv, None, 0.25)
    o_j = np.asarray(o_j, np.float32)
    np.testing.assert_array_equal(o_t.float().numpy(), o_j)
    assert abs(o_j[0, 0, 0, 0] + 0.4885) < 4e-3
    # the same function with P rounded to bf16 first, as kernel #5 does
    s = (tq.float() * 0.25) @ tk.float().transpose(-1, -2)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    rounded = (p.bfloat16().float() @ tv.float() / p.sum(-1, keepdim=True)).bfloat16()
    assert not rounded.float().any()
    ulp = 2.0 ** (math.floor(math.log2(np.abs(o_j).max())) - 7)
    assert np.abs(rounded.float().numpy() - o_j).max() > 100 * ulp


def test_cpu_tensors_take_the_plain_versions():
    q, k, v, g, bias = _inputs(3, 2, 2, 9, 13, 8, "key")
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    before = fl.KERNEL.launches
    out = fl.flash_attention(*t, torch.from_numpy(bias))
    out.backward(torch.from_numpy(g))
    assert fl.KERNEL.launches == before and all(x.grad is not None for x in t)
    with pytest.raises(ValueError, match="broadcastable"):
        fl.flash_attention(*t, torch.zeros(2, 1, 3, 13))


@pytest.mark.parametrize("rate,kind", [(0.0, "none"), (0.0, "causal"), (0.0, "key"), (0.1, "key")])
def test_flash_route_like_jax(rate, kind, monkeypatch):
    """``dot_product_attention(impl="flash")`` with the routes replaced by
    recorders: both take the flash kernel at every site without live dropout,
    and the composable path with dropout at a site with a live rate."""
    b, h, sq, skv = 2, 2, 6, 6 if kind == "causal" else 11
    routes = []
    monkeypatch.setattr(jflash, "flash_attention", lambda q, *a: routes.append("flash") or q)
    monkeypatch.setattr(jattention, "_xla_attention", lambda q, *a, **kw: routes.append("xla") or q)
    monkeypatch.setattr(tattention, "flash_attention", lambda q, *a: routes.append("flash") or q)
    monkeypatch.setattr(tattention, "xla_attention", lambda q, *a, **kw: routes.append("xla") or q)
    bias = _bias(np.random.RandomState(0), kind, b, h, sq, skv)
    jattention.dot_product_attention(jnp.zeros((b, h, sq, 8)), jnp.zeros((b, h, skv, 8)),
                                     jnp.zeros((b, h, skv, 8)),
                                     None if bias is None else jnp.asarray(bias),
                                     dropout_rate=rate, dropout_rng=jax.random.PRNGKey(0),
                                     impl="flash")
    tattention.dot_product_attention(torch.zeros(b, h, sq, 8), torch.zeros(b, h, skv, 8),
                                     torch.zeros(b, h, skv, 8),
                                     None if bias is None else torch.from_numpy(bias),
                                     dropout_rate=rate, generator=torch.Generator().manual_seed(0),
                                     impl="flash")
    assert routes == (["flash", "flash"] if rate == 0.0 else ["xla", "xla"])
