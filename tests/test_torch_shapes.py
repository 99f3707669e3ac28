"""Every head dim and width JAX's kernels take: the port against the JAX package.

The kernels #1-#9 take any head dim from 1 to 256, #1/#3/#4 any width that
divides into heads and any FFN width, and #2 any width, in bf16 and float32
(csrc/attn_any.cuh, gemm_sm90.cuh's tail kernel, the padded adapter passes).
On the CPU each wrapper runs its plain version, so these tests hold the
plain versions at those shapes against the JAX package's Pallas kernels in
interpret mode, in float32:

* #5/#6 (``fused_short_attention``) and #7-#9 (``flash_attention``) at head
  dims 12, 32 and 80: o at rtol=atol=2e-5 and dq, dk, dv against ``jax.vjp``
  at rtol=1e-4, atol=2e-5, as tests/test_torch_fp32_attention.py holds them
  at 64;
* #1 (``_fwd_call``) and #3 (``jax.vjp`` of ``attn_block``) at widths 48
  (4 heads of 12), 128 (4 of 32) and 160 (2 of 80), rtol=1e-4, atol=1e-5
  as tests/test_torch_attn_block.py;
* #4 (``layer_block``) at width 48 with FFN width 96 (not multiples of 128),
  forward at rtol=atol=2e-5 and dx plus the active adapter's gradients at
  rtol=1e-4, atol=2e-5, as tests/test_torch_layer_block.py;
* #2 (``fused_ensemble_adapter``) at widths 48 and 100 (no multiple of 64),
  forward and gradients at rtol=1e-4, atol=1e-5 as
  tests/test_torch_adapter_fused.py;
* one tiny ViLT fused DAT step on ``"layer"`` at width 48 (heads of 12, FFN
  96), its parameters loaded through ``utils/param_bridge.py``, against the
  JAX step: losses at rtol=2e-5, parameters at rtol=1e-4, atol=1e-6, as
  tests/test_torch_train.py;
* the shape functions the wrappers and ``chip_smoke.py`` share: which
  kernels a head dim takes, the padded widths, the workspace bytes, and the
  ``ValueError`` past head dim 256.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feddat_tpu.configs.core import OptimizerConfig as JaxOptimizerConfig
from feddat_tpu.configs.core import PEFTMode as JaxPEFTMode
from feddat_tpu.ops import flash as jflash
from feddat_tpu.ops import fused_attention as jfused
from feddat_tpu.ops.adapter_fused import fused_ensemble_adapter as jax_adapter
from feddat_tpu.ops.attention import mask_to_bias as jax_mask_to_bias
from feddat_tpu.ops.attn_block import _fwd_call
from feddat_tpu.ops.attn_block import attn_block as jax_attn_block
from feddat_tpu.ops.layer_block import layer_block as jax_layer_block
from feddat_tpu.train import dat as jdat
from feddat_tpu_torch.configs.core import OptimizerConfig, PEFTMode
from feddat_tpu_torch.ops import adapter_fused as af
from feddat_tpu_torch.ops import attn_block as ab
from feddat_tpu_torch.ops import flash as fl
from feddat_tpu_torch.ops import fused_attention as fa
from feddat_tpu_torch.ops import layer_block as lb
from feddat_tpu_torch.ops.attention import mask_to_bias
from feddat_tpu_torch.train import dat as tdat
from feddat_tpu_torch.train.forwards import make_vilt_fused_parts, to_device
from feddat_tpu_torch.utils.param_bridge import vilt_from_flax

from conftest import TINY_VILT, tiny_batch
from test_layer_block import EPS, _kernel_args
from test_torch_fp32_attention import _bias
from test_torch_layer_block import _port_args
from test_torch_train import _jax_fused_step
from test_torch_vilt import jax_model_and_params, port_model

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=2e-5)
BLOCK_TOL = dict(rtol=1e-4, atol=1e-5)
HEAD_DIMS = (12, 32, 80)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _attention_inputs(seed, d, b, h, sq, skv, kind):
    rng = np.random.RandomState(seed)
    q, g = (rng.randn(b, h, sq, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, h, skv, d).astype(np.float32) for _ in range(2))
    return q, k, v, g, _bias(rng, kind, b, h, sq, skv)


def _attention_against_jax(jax_fn, torch_fn, q, k, v, g, bias):
    """o and dq, dk, dv of the port's autograd wrapper (plain versions on the
    CPU) against ``jax.vjp`` of the JAX custom_vjp over its Pallas kernels."""
    jbias = None if bias is None else jnp.asarray(bias)
    out_j, vjp = jax.vjp(lambda a, b_, c: jax_fn(a, b_, c, jbias, None, True),
                         *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(g))
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    out = torch_fn(*leaves, _t(bias))
    got = torch.autograd.grad(out, leaves, _t(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **FWD_TOL, err_msg="o")
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_fused_attention_matches_jax_at_head_dim(d):
    """#5/#6 at S=21 with a key-padding row (the default scale d^-0.5)."""
    q, k, v, g, bias = _attention_inputs(d, d, 2, 2, 21, 21, "key")
    _attention_against_jax(jfused.fused_short_attention, fa.fused_short_attention, q, k, v, g, bias)


@pytest.mark.parametrize("d,kind,sq,skv", [(12, "key", 9, 19), (32, "causal", 10, 10), (80, "heads", 13, 11)])
def test_flash_attention_matches_jax_at_head_dim(d, kind, sq, skv):
    """#7-#9 at a cross site (a key row), the training decoder's causal tile
    and a per-head tile."""
    q, k, v, g, bias = _attention_inputs(d + sq, d, 2, 2, sq, skv, kind)
    _attention_against_jax(jflash.flash_attention, fl.flash_attention, q, k, v, g, bias)


def _block_inputs(seed, b, s, dm):
    rng = np.random.RandomState(seed)
    return dict(
        x=(rng.randn(b, s, dm) * 0.5 + 0.1).astype(np.float32),
        ws=[(rng.randn(dm, dm) * 0.05).astype(np.float32) for _ in range(4)],  # flax [in, out]
        bqkv=(rng.randn(3, dm) * 0.02).astype(np.float32),
        bo=(rng.randn(1, dm) * 0.02).astype(np.float32),
        gb=np.stack([1.0 + 0.1 * rng.randn(dm), 0.1 * rng.randn(dm)]).astype(np.float32),
        mask=(rng.rand(b, s) > 0.25).astype(np.int32),
    )


@pytest.mark.parametrize("dm,heads", [(48, 4), (128, 4), (160, 2)])
def test_attn_block_matches_jax_at_width(dm, heads):
    """#1's out, ctx and lse (``_fwd_call``) and #3's dx (``jax.vjp``) with LN1
    fused at widths whose heads are 12, 32 and 80 wide, scale left to the
    kernels' default (the site's head dim)."""
    b, s, eps = 2, 19, 1e-12
    inp = _block_inputs(dm + s, b, s, dm)
    d = dm // heads
    bias_j = jax_mask_to_bias(jnp.asarray(inp["mask"]))
    out_j, (_, _, ctx_j, lse_j) = _fwd_call(
        jnp.asarray(inp["x"]), *map(jnp.asarray, inp["ws"]), jnp.asarray(inp["bqkv"]),
        jnp.asarray(inp["bo"]), jnp.asarray(inp["gb"]), bias_j, heads, d ** -0.5, 1, True, eps)
    ws = [_t(w.T) for w in inp["ws"]]
    args = (_t(inp["x"]), *ws, _t(inp["bqkv"]), _t(inp["bo"]), _t(inp["gb"]),
            mask_to_bias(_t(inp["mask"])), heads)
    out, ctx, lse = ab.attn_block_reference(*args, None, eps)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **BLOCK_TOL)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(ctx_j)[:b, :s], **BLOCK_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[:b, :, :s], **BLOCK_TOL)

    g = np.random.RandomState(s).randn(b, s, dm).astype(np.float32)

    def f(x):
        return jax_attn_block(x, *map(jnp.asarray, inp["ws"]), jnp.asarray(inp["bqkv"]),
                              jnp.asarray(inp["bo"]), jnp.asarray(inp["gb"]), bias_j, heads, None, 1,
                              True, eps)

    _, vjp = jax.vjp(f, jnp.asarray(inp["x"]))
    (want,) = vjp(jnp.asarray(g))
    x = _t(inp["x"]).requires_grad_()
    y = ab.attn_block(x, *args[1:], None, eps)
    (got,) = torch.autograd.grad(y, [x], _t(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)


@pytest.fixture(scope="module")
def layer48():
    """A JAX PreLNLayer at width 48 (4 heads of 12), FFN width 96 and
    bottleneck 12, with non-trivial LayerNorm rows and one padded key row."""
    from flax import traverse_util

    from feddat_tpu.configs.core import AdapterSpec
    from feddat_tpu.models.layers import PreLNLayer

    d, h, f, b, s = 48, 4, 96, 2, 21
    layer = PreLNLayer(hidden_size=d, num_heads=h, intermediate_size=f,
                       adapter=AdapterSpec(names=("adapter_0", "adapter_1", "adapter_2"),
                                           reduction_factor=4),
                       layer_norm_eps=EPS, attn_impl="auto")
    rng = np.random.RandomState(48)
    x = rng.randn(b, s, d).astype(np.float32) * 0.3
    bias = np.zeros((b, 1, 1, s), np.float32)
    bias[0, :, :, -3:] = -1e9
    params = layer.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(bias),
                        adapter_mode="init_all")["params"]
    flat = traverse_util.flatten_dict(params)
    for i, k in enumerate(sorted(flat)):
        if k[-2] in ("norm_before", "norm_after"):
            flat[k] = flat[k] + 0.1 * jax.random.normal(jax.random.PRNGKey(i), flat[k].shape)
    return traverse_util.unflatten_dict(flat), jnp.asarray(x), jnp.asarray(bias), h


@pytest.mark.parametrize("mode", ["ensemble", "adapter_1"])
def test_layer_block_matches_jax_at_width_48(layer48, mode):
    """#4's plain version through the port's autograd wrapper: the forward,
    dx and the active adapter's four gradients against ``jax.vjp``."""
    params, x, bias, h = layer48
    weights, (w_a, w_b, use_b), _ = _kernel_args(params, mode)
    gw = np.random.RandomState(2).randn(*x.shape).astype(np.float32)

    def f(x_, wda, bda, wua, bua):
        w = list(weights)
        w[12:16] = [wda, bda, wua, bua]
        return jax_layer_block(x_, *w, bias, h, None, EPS, EPS, w_a, w_b, use_b, 1, True)

    out_j, vjp = jax.vjp(f, x, *weights[12:16])
    want = vjp(jnp.asarray(gw))
    targs = _port_args(weights)
    leaves = [_t(np.asarray(x)).requires_grad_()] + [t.requires_grad_() for t in targs[12:16]]
    targs[12:16] = leaves[1:]
    out = lb.layer_block(leaves[0], *targs, _t(np.asarray(bias)), h, None, EPS, EPS, w_a, w_b, use_b)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **FWD_TOL)
    got = torch.autograd.grad(out, leaves, _t(gw))
    for name, a, w in zip(("dx", "dwda", "dbda", "dwua", "dbua"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("d", [48, 100])
def test_adapter_matches_jax_at_width(d):
    """#2's forward and gradients at a width that is no multiple of 64."""
    rng = np.random.RandomState(d)
    h = rng.randn(3, 5, d).astype(np.float32)
    pa, pb = ([(rng.randn(*shape) * 0.1).astype(np.float32) for shape in ((d, 8), (8,), (8, d), (d,))]
              for _ in range(2))
    jargs = (jnp.asarray(h), tuple(map(jnp.asarray, pa)), tuple(map(jnp.asarray, pb)))
    want = jax_adapter(*jargs, 0.5, True)
    gj = jax.grad(lambda a, b, c: jnp.sum(jax_adapter(a, b, c, 0.5, True) ** 2), argnums=(0, 1, 2))(*jargs)
    th = _t(h).requires_grad_()
    ta, tb = ([_t(p).requires_grad_() for p in ps] for ps in (pa, pb))
    out = af.fused_ensemble_adapter(th, ta, tb, 0.5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **BLOCK_TOL)
    got = torch.autograd.grad((out ** 2).sum(), [th, *ta, *tb])
    for a, w in zip(got, [gj[0], *gj[1], *gj[2]]):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **BLOCK_TOL)


@pytest.mark.parametrize("dm", [48, 192])
def test_adapter_passes_at_the_padded_width_change_nothing(dm):
    """#4's adapter passes run at Dm rounded up to 128 (csrc/layer_block.cu)
    on o and g copied into zero-padded planes and on the weights
    ``_pad_adapter`` pads: the padded columns change no ReLU gate and no
    g_o, and the first Dm columns of the gradients are the unpadded ones
    (the wrapper drops the rest, which are 0)."""
    rng = np.random.RandomState(dm)
    m, r, dw = 37, 16, lb.padded_width(dm)
    o, g = (_t(rng.randn(m, dm).astype(np.float32)) for _ in range(2))
    wd, wu = _t(rng.randn(dm, r).astype(np.float32) * 0.1), _t(rng.randn(r, dm).astype(np.float32) * 0.1)
    bd = _t(rng.randn(1, r).astype(np.float32))
    relu, g_delta, g_down = lb.adapter_bwd_reference(o, g, wd, bd, wu, 0.5)
    want = lb.adapter_wgrads_reference(o, relu, g_delta, g_down)
    g_o = g + g_down @ wd.t()
    wdp, bdp, wup, wdp_t = lb._pad_adapter(wd, bd, wu, r, dw)
    assert wdp.shape == (dw, r) and wup.shape == (r, dw) and torch.equal(wdp_t, wdp.t())
    op, gp = (torch.nn.functional.pad(t, (0, dw - dm)) for t in (o, g))
    relu_p, g_delta_p, g_down_p = lb.adapter_bwd_reference(op, gp, wdp, bdp, wup, 0.5)
    got = lb.adapter_wgrads_reference(op, relu_p, g_delta_p, g_down_p)
    assert torch.equal(relu_p, relu) and torch.equal(g_down_p, g_down)
    np.testing.assert_allclose((gp + g_down_p @ wdp.t())[:, :dm].numpy(), g_o.numpy(), rtol=1e-6, atol=1e-6)
    for a, w, cut in zip(got, want, (np.s_[:dm], np.s_[:], np.s_[:, :dm], np.s_[:dm])):
        np.testing.assert_allclose(a[cut].numpy(), w.numpy(), rtol=1e-6, atol=1e-6)
    for a, cut in ((got[0], np.s_[dm:]), (got[2], np.s_[:, dm:]), (got[3], np.s_[dm:])):
        assert not a[cut].any()


WIDE48 = TINY_VILT.__class__(**{**TINY_VILT.__dict__, "hidden_size": 48, "intermediate_size": 96})
OPT = dict(lr=1e-2, weight_decay=1e-2)
HEADS = {"coco": dict(num_labels=16)}


def test_vilt_fused_dat_step_on_layer_matches_jax_at_width_48():
    """Two fused DAT steps of a ViLT at width 48 (4 heads of 12, FFN 96,
    bottleneck 12) on ``"layer"``: every layer of every pass takes #4's
    route, at a width whose heads are no multiple of 8 and whose FFN is no
    multiple of 128."""
    jmodel, params = jax_model_and_params(WIDE48, heads=HEADS)
    batch = tiny_batch(np.random.RandomState(6), cfg=WIDE48)
    batch["attention_mask"][0, 5:] = 0
    part = jdat.Partitioner(params, "coco", JaxPEFTMode.DAT)
    jopt = JaxOptimizerConfig(**OPT)
    jstep = _jax_fused_step(jmodel, params, part, jopt)
    jstate = jdat.init_train_state(params, part, jopt, jax.random.PRNGKey(0))

    model = port_model(WIDE48, params, "layer", HEADS)
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    assert set(sd) == set(vilt_from_flax(params))
    tpart_ = tdat.Partitioner(sd, "coco", PEFTMode.DAT)
    topt = OptimizerConfig(**OPT)
    step = tdat.make_dat_train_step_fused(*make_vilt_fused_parts(model, "coco"), tpart_, topt, 100)
    state = tdat.init_train_state(sd, tpart_, topt, torch.Generator().manual_seed(0))
    tbatch = to_device(batch, torch.device("cpu"))
    calls = []
    real = lb.layer_block
    lb_patch = pytest.MonkeyPatch()
    lb_patch.setattr(lb, "layer_block", lambda *a: calls.append(a[0].shape) or real(*a))
    try:
        for _ in range(2):
            jstate, jm = jstep(jstate, batch)
            state, m = step(state, tbatch)
            np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=2e-5)
            np.testing.assert_allclose(float(m["loss_shared"]), float(jm["loss_shared"]), rtol=2e-5)
            for k, v in vilt_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params)).items():
                np.testing.assert_allclose(state.params[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-6,
                                           err_msg=k)
    finally:
        lb_patch.undo()
    assert len(calls) == 2 * 2 * WIDE48.num_layers and {c[-1] for c in calls} == {48}


# ------------------------------------------------------------ shape functions
@pytest.mark.parametrize("d,kernels,chunks,padded", [
    (1, "any", 1, 64), (8, "any", 1, 64), (12, "any", 1, 64), (64, "hd64", 1, 64), (65, "any", 2, 128),
    (80, "any", 2, 128), (128, "any", 2, 128), (192, "any", 3, 192), (256, "any", 4, 256)])
def test_head_dim_instances_and_padding(d, kernels, chunks, padded):
    """Head dim 64 keeps its own kernels; every other head dim up to 256 takes
    csrc/attn_any.cuh's, padded to whole 64-column chunks."""
    assert fa.head_dim_kernels(d) == kernels
    assert fa.head_dim_chunks(d) == chunks and fa.padded_head_dim(d) == padded
    fa.check_head_dim("t", d)


@pytest.mark.parametrize("d", [0, 257, 264, 512])
def test_head_dims_past_256_raise(d):
    with pytest.raises(ValueError, match="head dims from 1 to 256"):
        fa.check_head_dim("fused_attention_fwd_cuda", d)
    with pytest.raises(ValueError, match="heads of 1 to 256"):
        ab.check_heads("attn_block_cuda", 2 * d, 2)


@pytest.mark.parametrize("dm,heads", [(32, 4), (48, 4), (100, 4), (192, 3), (1280, 16), (384, 12), (15, 3)])
def test_block_widths_the_kernels_take(dm, heads):
    """#1/#3/#4 take every width that divides into heads of 1 to 256; #4's
    adapter passes run at the width rounded up to 128, #2 at it rounded up
    to 64; a width that does not divide into the heads raises."""
    ab.check_heads("t", dm, heads)
    assert lb.padded_width(dm) % 128 == 0 and 0 <= lb.padded_width(dm) - dm < 128
    assert af.takes(dm, 8) and af.padded_width(dm) % 64 == 0 and 0 <= af.padded_width(dm) - dm < 64
    with pytest.raises(ValueError, match="divides into heads"):
        ab.check_heads("t", dm + 1, heads) if (dm + 1) % heads else ab.check_heads("t", dm, heads + 1)


@pytest.mark.parametrize("b,h,s,d", [(2, 12, 185, 64), (3, 16, 185, 80), (1, 3, 7, 12), (2, 2, 65, 256)])
def test_workspace_bytes(b, h, s, d):
    """The float32 kernels' scratch: three bf16 term planes [B, H, S, D] per
    operand (q, k, v, and dO in the backward; flash's k and v over Skv);
    none in bf16.  At head dim 64 the sizes are the head-dim-64 kernels'."""
    assert fa.fused_workspace_bytes(b, h, s, d, False, True) == 3 * 3 * b * h * s * d * 2
    assert fa.fused_workspace_bytes(b, h, s, d, True, True) == 4 * 3 * b * h * s * d * 2
    assert fa.fused_workspace_bytes(b, h, s, d, True, False) == 0
    sq, skv = s, s + 5
    assert fl.flash_workspace_bytes(b, h, sq, skv, d, False, True) == 2 * 3 * d * b * h * (sq + 2 * skv)
    assert fl.flash_workspace_bytes(b, h, sq, skv, d, True, True) == 2 * 3 * d * b * h * (2 * sq + 2 * skv)
    assert fl.flash_workspace_bytes(b, h, sq, skv, d, True, False) == 0


def test_empty_heads_takes_the_operands_head_dim():
    """``_empty_heads`` allocates the operands' D, laid out [B, S, H, D]."""
    t = fa._empty_heads(2, 3, 5, "cpu", torch.float32, 80)
    assert t.shape == (2, 3, 5, 80) and t.stride() == (5 * 3 * 80, 80, 3 * 80, 1)
    assert fa._empty_heads(2, 3, 5, "cpu", torch.bfloat16).shape == (2, 3, 5, 64)


def test_default_scale_is_the_sites_head_dim():
    """The kernels' default scale is the site's head dim ** -0.5, as the
    plain versions take it (a head dim other than 64 used to get 64 ** -0.5)."""
    inp = _block_inputs(3, 1, 9, 48)
    args = (_t(inp["x"]), *(_t(w.T) for w in inp["ws"]), _t(inp["bqkv"]), _t(inp["bo"]), None,
            mask_to_bias(_t(inp["mask"])), 4)
    default = ab.attn_block_reference(*args, None, None)
    explicit = ab.attn_block_reference(*args, 12 ** -0.5, None)
    for a, b in zip(default, explicit):
        assert torch.equal(a, b)
    import inspect

    src = inspect.getsource(ab.attn_block_cuda) + inspect.getsource(ab.attn_block_bwd_cuda)
    assert src.count("scale = (dm // num_heads) ** -0.5") == 2 and "HEAD_DIM" not in src
