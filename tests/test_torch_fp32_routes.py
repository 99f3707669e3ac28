"""The "block" and "layer" routes in float32 and at every adapter bottleneck.

* The JAX ``layer_block`` in float32 (its Pallas kernels in interpret mode, as
  tests/test_layer_block.py runs them) against the port's plain #4 through
  its autograd wrapper, forward and ``jax.vjp``'s five gradients, at
  bottlenecks 5, 24 and 96 with Dm=128 (head dim 64, the card's): forward at
  rtol=atol=2e-5, gradients at rtol=1e-4, atol=2e-5, as
  tests/test_torch_layer_block.py holds the same function at R=16.
* #4's wrapper pads any bottleneck to the kernel's chunks
  (``ops/layer_block.py::padded_bottleneck``): the plain #4 on the padded
  adapters gives the unpadded outputs and zero gradients in the padded
  columns (rtol=atol=1e-6: the same fp32 products with zero terms added).
* The port's layer gate against JAX's ``_layer_kernel_eligible``, with and
  without ``FEDDAT_LAYER_MAX_S``.
* The CLI's float32 refusals on the card, the engines' model check, the
  float32 patch embedding's convolution, and ``chip_smoke.py``'s float64
  evaluation of the plain #4.
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from feddat_tpu.configs.core import AdapterSpec as JaxAdapterSpec
from feddat_tpu.models.layers import PreLNLayer as JaxPreLNLayer
from feddat_tpu.ops.layer_block import layer_block as jax_layer_block
from feddat_tpu_torch import cli as tcli
from feddat_tpu_torch.configs.core import AdapterSpec
from feddat_tpu_torch.federated.engine import ENGINE_MODELS, FederatedTrainer
from feddat_tpu_torch.federated.spmd import SPMDFederatedTrainer
from feddat_tpu_torch.models import layers as tlayers
from feddat_tpu_torch.ops import layer_block as lb

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

DM, H, FF, B, S = 128, 2, 256, 2, 17
EPS = 1e-12
BOTTLENECKS = (5, 24, 96)
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=2e-5)
_TORCH_LAYOUT = (0, 1, 2, 3, 8, 10)  # wq, wk, wv, wo, w1, w2: flax [in, out] -> [out, in]


def _weights(r, seed):
    """layer_block's 20 weights in the JAX layout (flax kernels [in, out]),
    float32, with non-trivial biases and LayerNorm rows."""
    rng = np.random.RandomState(seed)

    def n(*shape, std):
        return (rng.randn(*shape) * std).astype(np.float32)

    def ln():
        return np.stack([1.0 + n(DM, std=0.1), n(DM, std=0.1)])

    def adapter():
        return [n(DM, r, std=0.1), n(1, r, std=0.5), n(r, DM, std=0.1), n(1, DM, std=0.5)]

    return [n(DM, DM, std=0.05) for _ in range(4)] + [
        n(3, DM, std=0.5), n(1, DM, std=0.5), ln(), ln(),
        n(DM, FF, std=0.05), n(1, FF, std=0.5), n(FF, DM, std=0.05), n(1, DM, std=0.5),
    ] + adapter() + adapter()


def _inputs(r):
    rng = np.random.RandomState(100 + r)
    x = (rng.randn(B, S, DM) * 0.3).astype(np.float32)
    bias = np.zeros((B, 1, 1, S), np.float32)
    bias[0, ..., -3:] = -1e9  # one row with padded keys
    g = rng.randn(B, S, DM).astype(np.float32)
    return x, bias, g, _weights(r, r)


@pytest.fixture(scope="module")
def jax_results():
    """The JAX layer's output and vjp (x and the active adapter) per
    bottleneck, ensemble mode (w_a = w_b = 0.5, the partner frozen)."""
    out = {}
    for r in BOTTLENECKS:
        x, bias, g, w = _inputs(r)
        wj = [jnp.asarray(t) for t in w]

        def f(x_, wda, bda, wua, bua, wj=wj, bias=bias):
            ws = list(wj)
            ws[12:16] = wda, bda, wua, bua
            return jax_layer_block(x_, *ws, jnp.asarray(bias), H, None, EPS, EPS, 0.5, 0.5, True, 1, True)

        y, vjp = jax.vjp(f, jnp.asarray(x), *wj[12:16])
        out[r] = (np.asarray(y), [np.asarray(t) for t in vjp(jnp.asarray(g))])
    return out


def _port(r):
    x, bias, g, w = _inputs(r)
    args = [torch.tensor(a.T.copy() if i in _TORCH_LAYOUT else a) for i, a in enumerate(w)]
    xt = torch.tensor(x).requires_grad_()
    for t in args[12:16]:
        t.requires_grad_()
    y = lb.layer_block(xt, *args, torch.tensor(bias), H, None, EPS, EPS, 0.5, 0.5, True)
    return y, torch.autograd.grad(y, [xt, *args[12:16]], torch.tensor(g))


@pytest.mark.parametrize("r", BOTTLENECKS)
def test_layer_block_fp32_forward_matches_jax(jax_results, r):
    y, _ = _port(r)
    np.testing.assert_allclose(y.detach().numpy(), jax_results[r][0], **FWD_TOL)


@pytest.mark.parametrize("r", BOTTLENECKS)
def test_layer_block_fp32_grads_match_jax_vjp(jax_results, r):
    _, got = _port(r)
    for name, k, want in zip(("dx", "dwda", "dbda", "dwua", "dbua"), got, jax_results[r][1]):
        assert k.shape == want.shape, name
        np.testing.assert_allclose(k.numpy(), want, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("r", [1, 5, 16, 24, 48, 64, 80, 96, 100, 192, 384])
def test_padded_bottleneck_is_whole_chunks_of_one_width(r):
    """Chunks of at most 64 columns (16 in float32), all of one width that is
    a multiple of 16, as few as cover r: what csrc/layer_block.cu takes."""
    for f32, most in ((False, 64), (True, 16)):
        rp = lb.padded_bottleneck(r, f32)
        n = -(-r // most)
        assert rp % n == 0 and (rp // n) % 16 == 0 and rp // n <= most and r <= rp < r + 16 * n
    assert lb.padded_bottleneck(96, False) == 96 and lb.padded_bottleneck(192, False) == 192
    assert lb.padded_bottleneck(48, True) == 48 and lb.padded_bottleneck(24, False) == 32


@pytest.mark.parametrize("r", [5, 24, 100])
def test_padded_adapters_change_nothing(r):
    """The wrapper's zero padding (``_pad_adapter``) through the plain #4:
    the same dx, the adapter's gradients in its own columns, zeros in the
    padded ones."""
    x, bias, g, w = _inputs(r)
    t = [torch.tensor(a.T.copy() if i in _TORCH_LAYOUT else a) for i, a in enumerate(w)]
    rp = lb.padded_bottleneck(r, True)
    assert rp > r
    cfg = (H, None, EPS, EPS, 0.5, 0.5, True)
    attn, ctx, lse = lb.attn_block_reference(torch.tensor(x), *t[:4], t[4], t[5], t[6],
                                             torch.tensor(bias), H, None, EPS)
    base = (torch.tensor(x), attn, ctx, lse, torch.tensor(g), torch.tensor(bias), *t[:4], t[4], t[6], t[7],
            *t[8:12])
    want = lb.layer_block_bwd_reference(*base, *t[12:20], *cfg)
    pa, pb = lb._pad_adapter(*t[12:15], rp), lb._pad_adapter(*t[16:19], rp)
    assert pa[0].shape == (DM, rp) and pa[3].shape == (rp, DM) and torch.equal(pa[3], pa[0].t())
    got = lb.layer_block_bwd_reference(*base, pa[0], pa[1], pa[2], t[15], pb[0], pb[1], pb[2], t[19], *cfg)
    tol = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), **tol)
    np.testing.assert_allclose(got[1][:, :r].numpy(), want[1].numpy(), **tol)
    np.testing.assert_allclose(got[2][:r].numpy(), want[2].numpy(), **tol)
    np.testing.assert_allclose(got[3][:r].numpy(), want[3].numpy(), **tol)
    np.testing.assert_allclose(got[4].numpy(), want[4].numpy(), **tol)
    for pad in (got[1][:, r:], got[2][r:], got[3][r:]):
        assert not pad.any()


@pytest.mark.parametrize("env", [None, "1024"])
@pytest.mark.parametrize("s", [592, 600])
@pytest.mark.parametrize("r", [8, 24, 96, 192])
def test_layer_gate_matches_jax(r, s, env, monkeypatch):
    """The port's whole-layer gate has JAX's terms and no others: every
    bottleneck, and ``FEDDAT_LAYER_MAX_S`` read at the call (default 592)."""
    if env is None:
        monkeypatch.delenv("FEDDAT_LAYER_MAX_S", raising=False)
    else:
        monkeypatch.setenv("FEDDAT_LAYER_MAX_S", env)
    names = ("adapter_0", "adapter_1", "adapter_2")
    jl = JaxPreLNLayer(hidden_size=768, num_heads=12, intermediate_size=64,
                       adapter=JaxAdapterSpec(names=names, reduction_factor=768 // r), attn_impl="layer")
    tl = tlayers.PreLNLayer(768, 12, 64, AdapterSpec(names=names, reduction_factor=768 // r),
                            attn_impl="layer")
    assert tl.adapter.bottleneck == r
    for mode in ("adapter_0", "ensemble"):
        want = jl._layer_kernel_eligible(None, mode, True, None, jnp.zeros((1, s, 768)))
        got = tl._layer_kernel_eligible(None, mode, True, None, torch.zeros(1, s, 768))
        assert got == want == (s <= int(env or 592))


@pytest.mark.parametrize("impl", ["block", "layer", "fused", "flash"])
def test_cli_float32_on_the_card(impl):
    """float32 passes the check on the card on every kernel route: #1-#4
    ("block", "layer") and #5-#9 ("fused", "flash") all take it."""
    args = tcli.build_parser().parse_args(
        ["--encoder_name", "vilt", "--device", "cuda", "--dtype", "float32", "--attn_impl", impl])
    tcli.refuse_unported(args)


@pytest.mark.parametrize("engine", ["sequential", "spmd"])
def test_engines_name_the_models_they_train(engine):
    make = FederatedTrainer if engine == "sequential" else SPMDFederatedTrainer
    args = (torch.nn.Linear(2, 2), None, {}, None) + ((None,) if engine == "spmd" else ())
    with pytest.raises(TypeError) as err:
        make(*args, device="cpu")
    msg = str(err.value)
    assert "Linear" in msg and all(m in msg for m in ENGINE_MODELS) and "ROADMAP" not in msg


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_patch_conv2d_is_the_convolution(dtype):
    """On the CPU the patch embedding is F.conv2d itself, and cuDNN's TF32
    flag is as it was after the call."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 64, 96, generator=gen).to(dtype)
    w, b = (torch.randn(16, 3, 32, 32, generator=gen) * 0.02).to(dtype), torch.randn(16).to(dtype)
    before = torch.backends.cudnn.allow_tf32
    assert torch.equal(tlayers.patch_conv2d(x, w, b, 32), F.conv2d(x, w, b, stride=32))
    assert torch.backends.cudnn.allow_tf32 == before


def test_chip_smoke_float64_reference_is_the_plain_function():
    """chip_smoke.py's fp32 phase evaluates the plain #4 with a given gate
    (``layer_bwd_gated``) and in float64 (``float64_mode``): with the gate
    down > 0 it is ``layer_block_bwd_reference`` itself, and in float64 mode
    every output is float64 and within fp32 rounding of the fp32 one."""
    x, bias, g, w = _inputs(24)
    t = [torch.tensor(a.T.copy() if i in _TORCH_LAYOUT else a) for i, a in enumerate(w)]
    cfg = (H, None, EPS, EPS, 1.0, 0.0, False)
    attn, ctx, lse = lb.attn_block_reference(torch.tensor(x), *t[:4], t[4], t[5], t[6],
                                             torch.tensor(bias), H, None, EPS)
    args = (torch.tensor(x), attn, ctx, lse, torch.tensor(g), torch.tensor(bias), *t[:4], t[4], t[6], t[7],
            *t[8:20])
    want = lb.layer_block_bwd_reference(*args, *cfg)
    o = lb.ffn_recompute_reference(*args[:2], t[7], *t[8:12], EPS)[4]
    gate = o @ t[12] + t[13][0] > 0
    got = chip_smoke.layer_bwd_gated(torch, args, cfg, gate)
    for k, r in zip(got, want):
        assert torch.equal(k, r)
    with chip_smoke.float64_mode(torch):
        exact = chip_smoke.layer_bwd_gated(torch, chip_smoke.to_float64(torch, args), cfg, gate)
    for k, r in zip(exact, want):
        assert k.dtype == torch.float64
        np.testing.assert_allclose(k.numpy(), r.double().numpy(), rtol=1e-4, atol=1e-5)
    planted = chip_smoke.bf16_operands(torch, args, (0,))
    assert planted[0].dtype == torch.float32 and torch.equal(planted[0], args[0].bfloat16().float())
