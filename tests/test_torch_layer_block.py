"""The port's whole-layer block (``ops/layer_block.py``: ``layer_fwd`` and the
plain version of backward kernel #4) against the JAX ``layer_block`` run in
interpret mode on the CPU, in float32, with one padded key row and
non-trivial LayerNorm parameters (the setup of tests/test_layer_block.py).

Tolerances: the forward at rtol=atol=2e-5 (one fp32 function summed in
another order, as tests/test_layer_block.py holds the kernel to the
composable path); the gradients at rtol=1e-4, atol=2e-5 — they chain a dozen
products and two LayerNorm backwards, each summed in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feddat_tpu.ops.layer_block import layer_block as jax_layer_block
from feddat_tpu_torch.models.layers import PreLNLayer
from feddat_tpu_torch.configs.core import AdapterSpec
from feddat_tpu_torch.ops import layer_block as lb

from test_layer_block import B, D, EPS, F, H, RF, S, _kernel_args, _setup

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=2e-5)
_TORCH_LAYOUT = (0, 1, 2, 3, 8, 10)  # wq, wk, wv, wo, w1, w2: flax [in, out] -> [out, in]


def _port_args(weights):
    out = []
    for i, w in enumerate(weights):
        a = np.asarray(w, np.float32)
        out.append(torch.tensor(a.T if i in _TORCH_LAYOUT else a))
    return out


@pytest.fixture(scope="module")
def setup():
    return _setup()


@pytest.mark.parametrize("mode", ["ensemble", "adapter_1"])
def test_layer_fwd_matches_jax(setup, mode):
    _, params, x, bias = setup
    weights, (w_a, w_b, use_b), _ = _kernel_args(params, mode)
    want = jax_layer_block(x, *weights, bias, H, None, EPS, EPS, w_a, w_b, use_b, 1, True)
    got, (x_res, ctx, lse, aout) = lb.layer_fwd(
        torch.tensor(np.asarray(x)), *_port_args(weights), torch.tensor(np.asarray(bias)),
        H, None, EPS, EPS, w_a, w_b, use_b)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    assert ctx.shape == x_res.shape == aout.shape == (B, S, D) and lse.shape == (B, H, S)


def _ragged(mode: str):
    """``"<mode>@<S>"`` -> (mode, S): the setup's layer at B=1 and that S."""
    name, _, s = mode.partition("@")
    return name, (int(s) if s else None)


@pytest.mark.parametrize("mode", ["ensemble", "adapter_1", "ensemble@127", "adapter_1@129"])
def test_layer_block_grads_match_jax_vjp(setup, mode):
    """dx and the active adapter's four gradients of the port's autograd
    wrapper (plain backward on the CPU) against ``jax.vjp`` of the JAX
    custom_vjp (the Pallas backward kernel in interpret mode).  ``@127`` and
    ``@129`` run the same layer at B=1 and that S: the card's row counts on
    either side of the GEMM's 128-row tile."""
    _, params, x, bias = setup
    mode, s = _ragged(mode)
    b = B
    if s is not None:
        rng = np.random.RandomState(s)
        b, x = 1, jnp.asarray(rng.randn(1, s, D).astype(np.float32) * 0.3)
        bias = np.zeros((1, 1, 1, s), np.float32)
        bias[..., -3:] = -1e9  # padded keys, as the setup's first row
        bias = jnp.asarray(bias)
    weights, (w_a, w_b, use_b), _ = _kernel_args(params, mode)
    gw = np.random.RandomState(1).randn(b, x.shape[1], D).astype(np.float32)

    def f(x_, wda, bda, wua, bua):
        w = list(weights)
        w[12:16] = wda, bda, wua, bua
        return jax_layer_block(x_, *w, bias, H, None, EPS, EPS, w_a, w_b, use_b, 1, True)

    _, vjp = jax.vjp(f, x, *weights[12:16])
    want = vjp(jnp.asarray(gw))

    targs = _port_args(weights)
    xt = torch.tensor(np.asarray(x)).requires_grad_()
    for t in targs[12:16]:
        t.requires_grad_()
    for t in targs[16:20]:  # the frozen partner gets nothing even when it asks
        t.requires_grad_()
    out = lb.layer_block(xt, *targs, torch.tensor(np.asarray(bias)),
                         H, None, EPS, EPS, w_a, w_b, use_b)
    got = torch.autograd.grad(out, [xt, *targs[12:16]], torch.from_numpy(gw), retain_graph=True)
    for name, g, w in zip(("dx", "dwda", "dbda", "dwua", "dbua"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **GRAD_TOL)
    partner = torch.autograd.grad(out, targs[16:20], torch.from_numpy(gw), allow_unused=True)
    assert all(g is None for g in partner)


def test_layer_block_gradient_dtypes():
    """The plain backward's adapter gradients and dx are returned in fp32 and
    ``x.dtype``; the wrapper casts the weight gradients to the weight's
    dtype and keeps the bias gradients in theirs (layer_block.py:497-498)."""
    rng = np.random.RandomState(4)
    dm, h, ff, r, b, s = 32, 4, 64, 8, 2, 5
    t = lambda *shape, std=0.1: torch.from_numpy((rng.randn(*shape) * std).astype(np.float32))
    bf = torch.bfloat16
    x = t(b, s, dm, std=1.0).to(bf).requires_grad_()
    w = [t(dm, dm).to(bf) for _ in range(4)]
    ln = torch.stack([torch.ones(dm), torch.zeros(dm)])
    wda, wua = t(dm, r).to(bf).requires_grad_(), t(r, dm).to(bf).requires_grad_()
    bda, bua = t(1, r).requires_grad_(), t(1, dm).requires_grad_()
    out = lb.layer_block(x, *w, t(3, dm), t(1, dm), ln, ln, t(ff, dm).to(bf), t(1, ff),
                         t(dm, ff).to(bf), t(1, dm), wda, bda, wua, bua, wda, bda, wua, bua, None,
                         h, None, 1e-12, 1e-12, 1.0, 0.0, False)
    assert out.dtype == bf
    gx, gwda, gbda, gwua, gbua = torch.autograd.grad(out.float().sum(), [x, wda, bda, wua, bua])
    assert (gx.dtype, gwda.dtype, gwua.dtype) == (bf, bf, bf)
    assert (gbda.dtype, gbua.dtype, gbda.shape, gbua.shape) == (torch.float32,) * 2 + ((1, r), (1, dm))
    assert all(bool(torch.isfinite(g.float()).all()) for g in (gx, gwda, gbda, gwua, gbua))


def test_layer_route_matches_auto_route_fwd_and_grads():
    """PreLNLayer(attn_impl='layer') against the composable path on the same
    weights, ensemble and single modes (the port's counterpart of
    tests/test_layer_block.py::test_preln_layer_impl_matches_auto)."""
    spec = AdapterSpec(names=("adapter_0", "adapter_1", "adapter_2"), reduction_factor=RF)
    torch.manual_seed(0)
    auto = PreLNLayer(D, H, F, spec, layer_norm_eps=EPS, attn_impl="auto")
    layer = PreLNLayer(D, H, F, spec, layer_norm_eps=EPS, attn_impl="layer")
    with torch.no_grad():
        for p in auto.parameters():
            p.normal_(0.0, 0.1)
    layer.load_state_dict(auto.state_dict())
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(B, S, D).astype(np.float32) * 0.3)
    bias = torch.zeros(B, 1, 1, S)
    bias[0, ..., -3:] = -10000.0
    gw = torch.from_numpy(rng.randn(B, S, D).astype(np.float32))
    for mode, active in (("ensemble", "adapter_0"), ("adapter_1", "adapter_1")):
        outs, grads = [], []
        for mod in (auto, layer):
            xi = x.clone().requires_grad_()
            params = [p for n, p in mod.named_parameters() if f"{active}_" in n]
            out = mod(xi, bias, adapter_mode=mode)
            outs.append(out)
            grads.append(torch.autograd.grad(out, [xi, *params], gw))
        np.testing.assert_allclose(outs[1].detach().numpy(), outs[0].detach().numpy(), **FWD_TOL)
        for g1, g0 in zip(grads[1], grads[0]):
            np.testing.assert_allclose(g1.numpy(), g0.numpy(), **GRAD_TOL)
    assert layer._layer_kernel_eligible(None, "adapter_0", True, None, torch.zeros(1, 592, D))
    assert not layer._layer_kernel_eligible(None, "adapter_0", True, None, torch.zeros(1, 593, D))
    assert not layer._layer_kernel_eligible(None, "weighted", True, None, x)


def test_plain_stages_compose_and_a_given_gate_replaces_down_gt_0():
    """The staged plain pieces that chip_smoke.py holds kernel #4's stages
    against: the FFN recompute, one adapter's backward and its weight
    gradients; with the recomputed gate passed in they give what they give
    without it, and a flipped gate entry moves g_down only there (exact: the
    same fp32 ops)."""
    rng = np.random.RandomState(5)
    dm, ff, r, b, s = 32, 64, 8, 2, 5
    t = lambda *shape, std=0.3: torch.from_numpy((rng.randn(*shape) * std).astype(np.float32))
    x, aout, g = t(b, s, dm, std=1.0), t(b, s, dm), t(b, s, dm, std=1.0)
    gb2 = torch.stack([1.0 + t(dm), t(dm)])
    h, xhat2, rstd2, p1, o = lb.ffn_recompute_reference(x, aout, gb2, t(ff, dm), t(1, ff),
                                                        t(dm, ff), t(1, dm), 1e-12)
    assert torch.equal(h, x + aout) and p1.shape == (b, s, ff) and o.shape == (b, s, dm)
    wd, bd, wu = t(dm, r), t(1, r), t(r, dm)
    relu, g_delta, g_down = lb.adapter_bwd_reference(o, g, wd, bd, wu, 0.5)
    down = o @ wd + bd[0]
    assert torch.equal(relu, torch.clamp(down, min=0.0)) and torch.equal(g_delta, g * 0.5)
    gate = down > 0
    for name, a_, b_ in zip(("relu", "g_delta", "g_down"), (relu, g_delta, g_down),
                            lb.adapter_bwd_reference(o, g, wd, bd, wu, 0.5, gate)):
        assert torch.equal(a_, b_), name
    flipped = gate.clone()
    flipped[0, 0, 0] = ~flipped[0, 0, 0]
    moved = lb.adapter_bwd_reference(o, g, wd, bd, wu, 0.5, flipped)[2] != g_down
    assert moved[0, 0, 0] and int(moved.sum()) == 1
    dwd, dbd, dwu, dbu = lb.adapter_wgrads_reference(o, relu, g_delta, g_down)
    rows = lambda v: v.reshape(b * s, -1)  # noqa: E731
    np.testing.assert_allclose(dwd.numpy(), (rows(o).t() @ rows(g_down)).numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dbd.numpy(), rows(g_down).sum(0).numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dwu.numpy(), (rows(relu).t() @ rows(g_delta)).numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dbu.numpy(), rows(g_delta).sum(0).numpy(), rtol=1e-6, atol=1e-6)


def test_erf_poly_matches_exact_erf():
    x = torch.linspace(-6.0, 6.0, 20001)
    assert float((lb.erf_poly(x) - torch.erf(x)).abs().max()) < 1e-6


def test_layer_block_past_448_matches_jax():
    """S=450 > LN_FWD_FUSED_MAX_S: the forward takes LN1 outside kernel #1
    (layer_block.py:357-376) while the backward re-derives it from x."""
    _layer_block_long_case(450, 9)


def test_layer_block_past_768_matches_jax():
    """S=769, past the 768 keys that #1's and #4's first CUDA attention
    cores held in shared memory; JAX's kernels have no such cap (its model
    gate sends S > 592 the "block" way, the kernel itself takes any S)."""
    _layer_block_long_case(769, 10)


def _layer_block_long_case(s, seed):
    _, params, _, _ = _setup()
    rng = np.random.RandomState(seed)
    x = jnp.asarray(rng.randn(1, s, D).astype(np.float32) * 0.3)
    weights, (w_a, w_b, use_b), _ = _kernel_args(params, "ensemble")
    gw = rng.randn(1, s, D).astype(np.float32)

    def f(x_, wda):
        w = list(weights)
        w[12] = wda
        return jax_layer_block(x_, *w, None, H, None, EPS, EPS, w_a, w_b, use_b, 1, True)

    want, vjp = jax.vjp(f, x, weights[12])
    want_dx, want_dwda = vjp(jnp.asarray(gw))
    targs = _port_args(weights)
    xt = torch.tensor(np.asarray(x)).requires_grad_()
    targs[12].requires_grad_()
    out = lb.layer_block(xt, *targs, None, H, None, EPS, EPS, w_a, w_b, use_b)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **FWD_TOL)
    dx, dwda = torch.autograd.grad(out, [xt, targs[12]], torch.from_numpy(gw))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), **GRAD_TOL)
    np.testing.assert_allclose(dwda.numpy(), np.asarray(want_dwda), **GRAD_TOL)
