"""The port's whole-sequence attention (``ops/fused_attention.py``) against the
JAX Pallas kernels #5/#6 (``feddat_tpu/ops/fused_attention.py``, interpret
mode, as tests/test_pallas_kernels.py runs them) on the CPU, where the port
takes its plain versions: the forward's o and lse (``_fwd_call``) and dq/dk/dv
through the autograd wrapper against ``jax.vjp`` of the custom_vjp, with no
bias, a padding bias and a batch-1 bias; and the ``impl="fused"`` routing gate
of ``dot_product_attention`` site by site.

Tolerances: fp32 rtol=1e-4, atol=1e-5 (the JAX package's own for this kernel,
tests/test_pallas_kernels.py:180,194: one fp32 function summed in another
order).  bf16: within 2 bf16 ulps of each output's largest magnitude — both
sides round P, o and the gradients to bf16 at the same points after fp32 sums
taken in another order, so an element may land one rounding apart."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feddat_tpu.ops import attention as jattention
from feddat_tpu.ops import fused_attention as jfused
from feddat_tpu_torch.ops import attention as tattention
from feddat_tpu_torch.ops import fused_attention as fa

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, b, h, s, d, bias_kind):
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(b, h, s, d).astype(np.float32) for _ in range(4))
    bias = None
    if bias_kind != "none":
        rows = b if bias_kind == "padding" else 1
        mask = (rng.rand(rows, s) > 0.3).astype(np.float32)
        mask[:, 0] = 1.0
        bias = ((1.0 - mask) * -10000.0)[:, None, None, :].astype(np.float32)
    return q, k, v, g, bias


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


# (bias kind, dtype, (b, h, s, d), seed): every bias kind in both dtypes at a
# ragged S; then, at the CUDA kernels' head dim, S at the edges of their 64-row
# tiles and S=1024, past the 768 keys that the earlier CUDA #5 took (a site the
# JAX gate admits at one head, GATE_CASES).
FWD_BWD_CASES = [
    pytest.param(kind, dtype, (2, 2, 21, 16), 10 * i + j, id=f"{kind}-{dtype}")
    for j, kind in enumerate(("none", "padding", "batch1")) for i, dtype in enumerate(DTYPES)
] + [
    pytest.param("padding", "bfloat16", shape, 30 + n, id="padding-bfloat16-" + "x".join(map(str, shape)))
    for n, shape in enumerate(((1, 1, 63, 64), (1, 1, 65, 64), (1, 2, 129, 64), (1, 1, 1024, 64)))
]


@pytest.mark.parametrize("bias_kind,dtype,shape,seed", FWD_BWD_CASES)
def test_forward_and_grads_match_jax_kernels(bias_kind, dtype, shape, seed):
    b, h, s, d = shape
    q, k, v, g, bias = _inputs(seed, b, h, s, d, bias_kind)
    (jq, jk, jv, jg, _), (tq, tk, tv, tg, _) = _both((q, k, v, g, None), dtype)
    jbias = None if bias is None else jnp.asarray(bias)
    tbias = None if bias is None else torch.from_numpy(bias)
    scale = d ** -0.5

    o_j, lse_j = jfused._fwd_call(jq, jk, jv, jbias, scale, True)
    o_t, lse_t = fa.fused_attention_fwd_ref(tq, tk, tv, tbias, scale)
    _check(o_t, o_j, dtype, "o")
    _check(lse_t, lse_j, dtype, "lse")

    _, vjp = jax.vjp(lambda a, b_, c: jfused.fused_short_attention(a, b_, c, jbias, None, True),
                     jq, jk, jv)
    want = vjp(jg)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = fa.fused_short_attention(*leaves, tbias)
    got = torch.autograd.grad(out, leaves, tg)
    np.testing.assert_array_equal(out.detach().float().numpy(), o_t.float().numpy())
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == DTYPES[dtype][1]
        _check(a, w, dtype, name)


def test_cpu_tensors_take_the_plain_versions():
    q, k, v, g, bias = _inputs(3, 2, 2, 9, 8, "padding")
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    before = (fa.KERNEL.launches, fa.KERNEL_BWD.launches)
    out = fa.fused_short_attention(*t, torch.from_numpy(bias))
    out.backward(torch.from_numpy(g))
    assert (fa.KERNEL.launches, fa.KERNEL_BWD.launches) == before
    with pytest.raises(ValueError, match="padding bias"):
        fa.fused_short_attention(*t, torch.zeros(2, 1, 9, 9))


# (heads, S, bias shape, live dropout rate, key length): ViLT's training
# (185), prompt (195) and serving (281) sequences, the gate's edge at H=12
# (295/296) and H=1 (1024/1025), ALBEF's ViT (577), and each other condition.
GATE_CASES = [
    (12, 185, "padding", 0.0, None),
    (12, 195, "padding", 0.0, None),
    (12, 281, "padding", 0.0, None),
    (12, 295, "padding", 0.0, None),
    (12, 296, "padding", 0.0, None),
    (12, 577, "padding", 0.0, None),
    (1, 1024, "padding", 0.0, None),
    (1, 1025, "padding", 0.0, None),
    (12, 185, "none", 0.0, None),
    (12, 185, "batch1", 0.0, None),
    (12, 185, "other_batch", 0.0, None),
    (12, 40, "causal", 0.0, None),
    (12, 185, "padding", 0.1, None),
    (12, 40, "padding", 0.0, 145),
]


@pytest.mark.parametrize("heads,s,bias_kind,rate,kv_len", GATE_CASES)
def test_fused_gate_routes_like_jax(heads, s, bias_kind, rate, kv_len, monkeypatch):
    """Both ``dot_product_attention(impl="fused")`` with the two routes replaced
    by recorders: the port takes the kernel exactly where JAX does.  The
    port's composable route refuses live dropout (ROADMAP Queue 1, item 13),
    which counts as taking that route."""
    b, skv = 2, kv_len or s
    bias_shape = {"padding": (b, 1, 1, skv), "batch1": (1, 1, 1, skv), "other_batch": (3, 1, 1, skv),
                  "causal": (1, 1, s, skv), "none": None}[bias_kind]
    routes = []
    monkeypatch.setattr(jfused, "fused_short_attention", lambda q, *a: routes.append("fused") or q)
    monkeypatch.setattr(jattention, "_xla_attention", lambda q, *a, **kw: routes.append("xla") or q)
    monkeypatch.setattr(tattention, "fused_short_attention", lambda q, *a: routes.append("fused") or q)
    monkeypatch.setattr(tattention, "xla_attention", lambda q, *a, **kw: routes.append("xla") or q)

    jq, jk = jnp.zeros((b, heads, s, 8)), jnp.zeros((b, heads, skv, 8))
    jbias = None if bias_shape is None else jnp.zeros(bias_shape)
    jattention.dot_product_attention(jq, jk, jk, jbias, dropout_rate=rate, impl="fused")
    tq, tk = torch.zeros(b, heads, s, 8), torch.zeros(b, heads, skv, 8)
    tbias = None if bias_shape is None else torch.zeros(bias_shape)
    try:
        tattention.dot_product_attention(tq, tk, tk, tbias, dropout_rate=rate, impl="fused")
    except NotImplementedError:
        assert rate > 0.0
        routes.append("xla")
    assert routes[0] == routes[1], routes
    assert routes[0] == ("fused" if tattention.fused_route_eligible(tq, tk, tbias, rate) else "xla")


def test_p_is_rounded_to_bf16_before_p_v():
    """A case where the rounding point of P shows: two keys with logits 0 and
    2^-10 (p = e^(-2^-10) and 1, both 1.0 in bf16) and values +1000 and -1000
    that cancel.  Rounding P to bf16 before P·v, as the TPU kernel does, gives
    o = 0 exactly; the unrounded P would give about -0.49."""
    d = 16
    q, k, v = (np.zeros((1, 1, 2, d), np.float32) for _ in range(3))
    q[..., 0] = 1.0
    k[0, 0, 1, 0] = 2.0 ** -8  # logits q.k/4: 0 and 2^-10
    v[0, 0, 0], v[0, 0, 1] = 1000.0, -1000.0
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), "bfloat16")
    o_j, _ = jfused._fwd_call(jq, jk, jv, None, 0.25, True)
    o_t, _ = fa.fused_attention_fwd_ref(tq, tk, tv, None, 0.25)
    assert not np.asarray(o_j, np.float32).any()
    np.testing.assert_array_equal(o_t.float().numpy(), np.asarray(o_j, np.float32))


def test_ds_is_rounded_to_bf16_before_dq_dk():
    """A case where the rounding point of ds shows (the card's ds probe,
    chip_smoke.py::fused_probes): lse given as 0 and q, k on disjoint dims, so
    every p is exactly 1; ds_a = (1 - 3u, 2 - 3u) (u = 2^-10) rounds to
    (1 - 4u, 2) in bf16.  With k1 = -k0/2 and q_b = -q_a, the TPU kernel's
    bf16(ds) gives dq_a0 = dk_0 = -2^-11 and dk_1 = 0; an fp32 ds would give
    -1.5u/8, -3u/8 and -3u/8.  Every sum is exact, so the two sides agree
    bitwise."""
    d = 64
    q, k, v, o, g = (np.zeros((1, 1, 2, d), np.float32) for _ in range(5))
    q[0, 0, 0, 32], q[0, 0, 1, 32] = 1.0, -1.0
    k[0, 0, 0, 0], k[0, 0, 1, 0] = 1.0, -0.5
    v[0, 0, 0, 0], v[0, 0, 1, 0] = 1.0, 2.0
    o[0, 0, 0, 0] = 3 * 2.0 ** -10
    g[0, 0, :, 0] = 1.0
    lse = np.zeros((1, 1, 2), np.float32)
    (jq, jk, jv, jo, jg), (tq, tk, tv, to, tg) = _both((q, k, v, o, g), "bfloat16")
    want = jfused._fused_bwd(0.125, True, (jq, jk, jv, None, jo, jnp.asarray(lse)), jg)[:3]
    got = fa.fused_attention_bwd_ref(tq, tk, tv, None, to, tg, torch.from_numpy(lse), 0.125)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(w, np.float32), err_msg=name)
    dq, dk = got[0].float().numpy(), got[1].float().numpy()
    assert dq[0, 0, 0, 0] == dk[0, 0, 0, 32] == -2.0 ** -11 and dk[0, 0, 1, 32] == 0.0


def test_fully_masked_row_is_the_unbiased_softmax():
    """Batch element 0 carries -10000 on every key: the exact two-pass max
    subtracts it, so its rows are the softmax without the bias (up to the
    fp32 rounding of logits near -10000), not a uniform average of v.  The
    plain #5/#6 against the JAX kernels there, in bf16."""
    b, h, s, d = 2, 2, 37, 64
    q, k, v, g, bias = _inputs(7, b, h, s, d, "padding")
    bias[0] = -10000.0
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _both((q, k, v, g), "bfloat16")
    jbias, tbias = jnp.asarray(bias), torch.from_numpy(bias)
    o_j, lse_j = jfused._fwd_call(jq, jk, jv, jbias, d ** -0.5, True)
    o_t, lse_t = fa.fused_attention_fwd_ref(tq, tk, tv, tbias, d ** -0.5)
    _check(o_t, o_j, "bfloat16", "o")
    _check(lse_t, lse_j, "bfloat16", "lse")
    o_free, _ = fa.fused_attention_fwd_ref(tq, tk, tv, None, d ** -0.5)
    uniform = tv.float().mean(-2, keepdim=True).expand_as(o_free)
    _check(o_t[0], o_free[0].float().numpy(), "bfloat16", "o against the unbiased softmax")
    assert (o_t[0].float() - uniform[0]).abs().max() > 0.1
    _, vjp = jax.vjp(lambda a, b_, c: jfused.fused_short_attention(a, b_, c, jbias, None, True), jq, jk, jv)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    got = torch.autograd.grad(fa.fused_short_attention(*leaves, tbias), leaves, tg)
    for name, a, w in zip(("dq", "dk", "dv"), got, vjp(jg)):
        _check(a, w, "bfloat16", name)
