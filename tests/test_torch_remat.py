"""Remat in the port (``feddat_tpu_torch/ops/remat_policy.py``) against its
own no-remat path and against the JAX package's remat'd models, on the CPU
at tiny widths.

* Every policy name on a tiny ViLT ("auto" and "block", the structural
  ``attention``/``min_save`` on the composable route): remat gives the
  no-remat loss and gradients (rtol 1e-6, atol 1e-7, as
  tests/test_albef.py:234-262 holds JAX's remat), with dropout off and live
  from one generator; and JAX's remat'd model at test_torch_vilt.py's
  tolerance (rtol 1e-4, atol 1e-5).
* What a region keeps, per policy: the tag names of the ops a policy keeps
  on one pre-LN layer in bf16 against the names of JAX's saved residuals
  (``jax.ad_checkpoint.print_saved_residuals``), and the bytes kept against
  the bytes autograd saves without remat (``saved_tensors_hooks``); with
  dropout live, the draws kept are bool masks, not fp32 uniforms.
* Names JAX refuses are refused with JAX's messages.
* The JAX package's tuned ALBEF configuration at tiny widths (the ViT on
  "layer" or "block", remat, the BERT towers on ``"names"``, fused LN): its
  parameter tree, forward, the standard and fused DAT steps' gradient sets
  against JAX's with dropout off, remat against no remat with dropout live,
  and the fused step's losses against JAX's by distribution.  JAX runs its
  Pallas kernels in interpret mode, the port their plain versions.

Both sides load one set of weights, drawn with numpy into the tree
``jax.eval_shape`` gives JAX's init (no JAX compile for the weights)."""

import contextlib
import dataclasses
import io
import re
from collections import Counter

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

from feddat_tpu.configs.core import AdapterSpec as JaxAdapterSpec
from feddat_tpu.configs.core import OptimizerConfig as JaxOptimizerConfig
from feddat_tpu.models.albef import AlbefModel as JaxAlbef
from feddat_tpu.models.layers import PreLNLayer as JaxPreLNLayer
from feddat_tpu.models.vilt import TaskHeadSpec as JaxHeadSpec
from feddat_tpu.models.vilt import ViltContinualLearner as JaxVilt
from feddat_tpu.ops.remat_policy import resolve_remat_policy as jax_resolve
from feddat_tpu.train import dat as jdat
from feddat_tpu.train.trainers import make_albef_fused_dat_step as jax_make_albef_fused_dat_step
from feddat_tpu_torch.configs.core import AdapterSpec, OptimizerConfig, PEFTMode
from feddat_tpu_torch.models.albef import AlbefModel
from feddat_tpu_torch.models.layers import PreLNLayer
from feddat_tpu_torch.models.vilt import TaskHeadSpec, ViltContinualLearner, init_vilt_params
from feddat_tpu_torch.ops import remat_policy as rp
from feddat_tpu_torch.train import dat as tdat
from feddat_tpu_torch.train import trainers
from feddat_tpu_torch.train.forwards import call_method, make_albef_forward, to_device
from feddat_tpu_torch.utils import seeding
from feddat_tpu_torch.utils.param_bridge import albef_from_flax, vilt_from_flax

from conftest import TINY_VILT, tiny_batch
from test_torch_albef import TINY, port_config as albef_port_config
from test_torch_albef_train import OPT, _jax_first_step_grads, _rel, _train_batch
from test_torch_vilt import port_config as vilt_port_config

EXACT = dict(rtol=1e-6, atol=1e-7)
JAX_TOL = dict(rtol=1e-4, atol=1e-5)
POLICIES = ("full", "dots", "names", "block_save", "block_save_nox", "block_save_ffn")
STRUCTURAL = ("attention", "min_save")
VILT_CASES = [("auto", p) for p in POLICIES + STRUCTURAL] + [("block", p) for p in POLICIES]
# JAX's block route runs the Pallas kernels in interpret mode, slow to
# compile: its remat'd ViLT is held at the tuned policy
JAX_BLOCK = ("block_save_nox",)
HEADS = {"coco": dict(num_labels=16)}
MODE = "adapter_0"
LIVE_VILT = dataclasses.replace(TINY_VILT, hidden_dropout=0.1, attention_dropout=0.1)
TUNED = dict(remat=True, remat_policy="block_save_nox", text_remat_policy="names", fuse_ln=True)


def random_like_init(abstract, seed):
    """numpy weights in the tree of ``jax.eval_shape(init)``: normal(0, 0.05),
    LayerNorm scales 1 + normal(0, 0.05)."""
    rng = np.random.RandomState(seed)

    def leaf(path, a):
        v = rng.normal(0.0, 0.05, a.shape).astype(np.float32)
        return v + 1.0 if jax.tree_util.keystr(path).endswith("['scale']") else v

    return jax.tree_util.tree_map_with_path(leaf, abstract)


# --------------------------------------------------------------------------- ViLT

def jax_vilt(cfg, impl="auto"):
    return JaxVilt(cfg, {k: JaxHeadSpec(**v) for k, v in HEADS.items()}, attn_impl=impl)


@pytest.fixture(scope="module")
def vilt_weights():
    batch = tiny_batch(np.random.RandomState(0), 2)
    model = jax_vilt(TINY_VILT)
    abstract = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), "coco", batch, adapter_mode="init_all"))["params"]
    return random_like_init(abstract, 1), batch


def _jax_loss(model, params, batch):
    _, logits = model.apply({"params": params}, "coco", batch, adapter_mode=MODE, deterministic=True)
    return (logits ** 2).mean()


@pytest.fixture(scope="module")
def jax_vilt_grads(vilt_weights):
    """JAX's remat'd ViLT: loss and gradients per (route, policy), one jit per
    route."""
    params, batch = vilt_weights
    out = {}
    for impl, names in (("auto", POLICIES + STRUCTURAL), ("block", JAX_BLOCK)):
        models = [jax_vilt(dataclasses.replace(TINY_VILT, remat=True, remat_policy=n), impl)
                  for n in names]
        res = jax.jit(lambda p: [jax.value_and_grad(lambda q, m=m: _jax_loss(m, q, batch))(p)
                                 for m in models])(params)
        for n, (loss, grads) in zip(names, res):
            out[impl, n] = float(loss), vilt_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    return out


def port_vilt_grads(cfg, impl, params, batch, seed=None):
    """The port's loss and the gradients of adapter_0 and the head, through
    ``call_method`` as a step calls it (the module's own weights differ from
    ``params``), dropout live from a generator seeded ``seed``."""
    model = init_vilt_params(ViltContinualLearner(
        vilt_port_config(cfg), {k: TaskHeadSpec(**v) for k, v in HEADS.items()}, attn_impl=impl), 7)
    sd = vilt_from_flax(params)
    train = sorted(k for k in sd if "adapter_0" in k or k.startswith("task_"))
    for k in train:
        sd[k].requires_grad_(True)
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    _, logits = call_method(model, sd, "forward", "coco", {k: torch.from_numpy(v) for k, v in batch.items()},
                            adapter_mode=MODE, deterministic=seed is None, rng=gen)
    loss = (logits ** 2).mean()
    return loss.detach(), dict(zip(train, torch.autograd.grad(loss, [sd[k] for k in train])))


def assert_same(got, want, tol):
    np.testing.assert_allclose(float(got[0]), float(want[0]), **tol)
    assert set(got[1]) == set(want[1])
    for k, v in want[1].items():
        np.testing.assert_allclose(got[1][k].numpy(), np.asarray(v), err_msg=k, **tol)


@pytest.mark.parametrize("impl,name", VILT_CASES)
def test_vilt_remat_equals_no_remat_and_jax(vilt_weights, jax_vilt_grads, impl, name):
    params, batch = vilt_weights
    plain = port_vilt_grads(TINY_VILT, impl, params, batch)
    got = port_vilt_grads(dataclasses.replace(TINY_VILT, remat=True, remat_policy=name), impl, params,
                          batch)
    assert_same(got, plain, EXACT)
    if impl == "auto" or name in JAX_BLOCK:
        loss, grads = jax_vilt_grads[impl, name]
        assert_same(got, (loss, {k: grads[k] for k in got[1]}), JAX_TOL)


@pytest.mark.parametrize("impl,name", VILT_CASES)
def test_vilt_remat_draws_the_forward_masks_again(vilt_weights, impl, name):
    """Dropout live: the recompute reads the forward's draws, so remat gives
    the no-remat loss and gradients from the same generator seed (another
    seed gives another loss)."""
    params, batch = vilt_weights
    cfg = dataclasses.replace(LIVE_VILT, remat=True, remat_policy=name)
    plain = port_vilt_grads(LIVE_VILT, impl, params, batch, seed=3)
    assert_same(port_vilt_grads(cfg, impl, params, batch, seed=3), plain, EXACT)
    assert float(port_vilt_grads(cfg, impl, params, batch, seed=4)[0]) != float(plain[0])


def test_remat_takes_one_tensor_passed_for_two_names(vilt_weights):
    """A step's parameters may hold one tensor under two names (the engine's
    teacher adapter_2 starts as adapter_1's tensors): the recompute must use
    it for both, not the module's own parameter for the second."""
    params, batch = vilt_weights
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = []
    for remat in (False, True):
        cfg = vilt_port_config(dataclasses.replace(TINY_VILT, remat=remat, remat_policy="names"))
        model = init_vilt_params(ViltContinualLearner(cfg, {"coco": TaskHeadSpec(16)}), 7)
        sd = vilt_from_flax(params)
        for k in list(sd):
            if "adapter_2" in k:
                sd[k] = sd[k.replace("adapter_2", "adapter_1")]
        train = sorted(k for k in sd if "adapter_0" in k)
        for k in train:
            sd[k].requires_grad_(True)
        _, logits = call_method(model, sd, "forward", "coco", tbatch, adapter_mode="ensemble")
        loss = (logits ** 2).mean()
        out.append((loss.detach(), dict(zip(train, torch.autograd.grad(loss, [sd[k] for k in train])))))
    assert_same(out[1], out[0], EXACT)


# ------------------------------------------------------------ what a region keeps

def _jax_saved_names(impl, name, x):
    """Tag names of the non-argument residuals JAX saves for one remat'd
    pre-LN layer (a line names its tag, or points at the checkpoint_name call
    that made it); untagged residuals count as ``"<untagged>"``."""
    layer = fnn.remat(JaxPreLNLayer, policy=jax_resolve(name), static_argnums=(3, 4))(
        hidden_size=32, num_heads=4, intermediate_size=64,
        adapter=JaxAdapterSpec(names=(MODE,), reduction_factor=4), dtype=jnp.bfloat16,
        attn_impl=impl)
    params = jax.eval_shape(lambda: layer.init(jax.random.PRNGKey(0), x, None, MODE, True))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax.ad_checkpoint.print_saved_residuals(
            lambda xx, p: layer.apply(p, xx, None, MODE, True).astype(jnp.float32).sum(), x, params)
    names = Counter()
    for line in buf.getvalue().splitlines():
        if "from the argument" in line:
            continue
        tagged = re.search(r"named '(\w+)'", line)
        if tagged is None:
            path, lineno = re.search(r"from (\S+\.py):(\d+):", line).groups()
            src = open(path).read().splitlines()[int(lineno) - 1]
            tagged = re.search(r'checkpoint_name\(.*"(\w+)"', src)
        names[tagged.group(1) if tagged else "<untagged>"] += 1
    return names


def _port_kept(impl, name, x):
    """(tag names of the ops the policy keeps, their bytes, the bytes autograd
    saves for the same layer without remat)."""
    torch.manual_seed(0)
    layer = PreLNLayer(32, 4, 64, AdapterSpec(names=(MODE,), reduction_factor=4),
                       dtype=torch.bfloat16, attn_impl=impl)
    policy = rp.resolve_remat_policy(name) or rp.FULL
    names, ops, kept = Counter(), [], []

    def spy(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if decision == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            for n in rp.active_names() or {"<untagged>"}:
                names[n] += 1
            ops.append(op)
            kept.extend(t.numel() * t.element_size() for t in jax.tree_util.tree_leaves(ctx.op_output)
                        if isinstance(t, torch.Tensor))
        return decision

    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        layer(x, None, MODE)
    fwd, _ = create_selective_checkpoint_contexts(spy)
    with fwd:
        layer(x, None, MODE)
    return names, sum(kept), sum(saved), ops


@pytest.mark.parametrize("impl", ["auto", "block"])
def test_kept_tensors_are_the_jax_policy_tags(impl):
    x_np = np.random.RandomState(0).randn(2, 5, 32).astype(np.float32)
    x_j = jnp.asarray(x_np, jnp.bfloat16)
    x_t = torch.from_numpy(x_np).bfloat16().requires_grad_(True)
    for name in POLICIES:
        got, kept, saved, ops = _port_kept(impl, name, x_t)
        want = _jax_saved_names(impl, name, x_j)
        if name == "dots":
            # every matmul output; JAX keeps those its backward reads (its
            # dead-code elimination drops the adapter's up projection)
            assert all(op in rp.DOT_OPS for op in ops), ops
            assert sum(got.values()) >= sum(want.values()) > 0
        elif (impl, name) == ("block", "names"):
            # kernel #1 returns attn_out with attn_ctx and attn_lse, which
            # "names" does not keep: the kernel runs again and attn_out comes
            # with it; JAX keeps attn_out and runs its kernel again as well
            assert got == Counter(ffn_preact=1) and want == Counter(attn_out=1, ffn_preact=1)
        else:
            assert got == want, (name, got, want)
        assert kept < saved, (name, kept, saved)
        if name == "full":
            assert kept == 0 and not got


@pytest.mark.parametrize("name", POLICIES)
def test_live_dropout_regions_keep_bool_masks(name):
    """Dropout live: the random draws a region keeps are the bool masks, one
    byte per element as the layer without remat saves them, never an fp32
    uniform; under "full" they are all it keeps."""
    torch.manual_seed(0)
    layer = PreLNLayer(32, 4, 64, AdapterSpec(names=(MODE,), reduction_factor=4), dropout_rate=0.1,
                       attention_dropout=0.1, dtype=torch.bfloat16)
    x = torch.randn(2, 5, 32).bfloat16().requires_grad_(True)
    policy = rp.resolve_remat_policy(name) or rp.FULL
    draws, kept = [], []

    def spy(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if decision == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            outs = [t for t in jax.tree_util.tree_leaves(ctx.op_output) if isinstance(t, torch.Tensor)]
            kept.extend(outs)
            if torch.Tag.nondeterministic_seeded in op.tags:
                draws.extend(outs)
        return decision

    fwd, _ = create_selective_checkpoint_contexts(spy)
    with fwd, seeding.dropout_rng(torch.Generator().manual_seed(1)):
        layer(x, None, MODE, deterministic=False)
    # one mask per site: the attention probabilities and two hidden dropouts
    assert sorted(t.numel() for t in draws) == [2 * 4 * 5 * 5, 2 * 5 * 32, 2 * 5 * 32]
    assert all(t.dtype == torch.bool for t in draws)
    if name == "full":
        assert len(kept) == len(draws)


def test_unknown_and_structural_names_raise_as_in_jax():
    for name, structural in (("bogus", True), ("bogus", False), ("attention", False),
                             ("min_save", False)):
        with pytest.raises(ValueError) as want:
            jax_resolve(name, supports_structural=structural)
        with pytest.raises(ValueError) as got:
            rp.resolve_remat_policy(name, supports_structural=structural)
        assert str(got.value) == str(want.value)
    for name in POLICIES + STRUCTURAL:
        assert (rp.resolve_remat_policy(name) is None) == (jax_resolve(name) is None)


@pytest.mark.parametrize("field,vision", [("remat_policy", "auto"), ("text_remat_policy", "layer")])
@pytest.mark.parametrize("name", ["attention", "bogus"])
def test_albef_towers_refuse_structural_names(field, vision, name):
    """The ViT (off "layer") and the BERT towers wire no structural policy:
    their forward raises JAX's message.  A ViT on "layer" never resolves its
    policy (vit.py:81), so the tower that raises there is BERT's."""
    cfg = albef_port_config(dataclasses.replace(TINY, remat=True, **{field: name}))
    model = AlbefModel(cfg, attn_impl="auto", vision_attn_impl=vision)
    batch = to_device(_train_batch(0), torch.device("cpu"))
    with pytest.raises(ValueError) as want:
        jax_resolve(name, supports_structural=False)
    with pytest.raises(ValueError) as got:
        model(batch, "ensemble", deterministic=True)
    assert str(got.value) == str(want.value)


def test_vilt_structural_names_and_layer_route_skip():
    """ViLT takes the structural names (its layers wire them); a "layer" ViT
    runs no region and so never resolves a bad name, as in JAX."""
    cfg = vilt_port_config(dataclasses.replace(TINY_VILT, remat=True, remat_policy="min_save"))
    model = ViltContinualLearner(cfg, {"coco": TaskHeadSpec(16)})
    assert all(layer.remat_ln and not layer.remat_attention for layer in model.vilt.layers)
    bad = AlbefModel(albef_port_config(dataclasses.replace(TINY, remat=True, remat_policy="bogus")),
                     attn_impl="auto", vision_attn_impl="layer")
    pix = torch.randn(2, 32, 32, 3)
    assert bad.visual_encoder(pix, "adapter_0").shape == (2, 5, 32)


# ------------------------------------------------------------ the tuned ALBEF

@pytest.fixture(scope="module")
def albef_weights():
    """numpy weights in the tree of the tuned JAX model's init, which equals
    the plain model's tree."""
    batch = _train_batch(3)

    def abstract(cfg):
        return jax.eval_shape(lambda: JaxAlbef(cfg, vision_attn_impl="layer").init(
            jax.random.PRNGKey(0), batch, adapter_mode="init_all", deterministic=True))["params"]

    tuned = abstract(dataclasses.replace(TINY, **TUNED))
    assert jax.tree_util.tree_structure(tuned) == jax.tree_util.tree_structure(abstract(TINY))
    return random_like_init(tuned, 2)


def port_albef(weights, vision, cfg=TINY, remat=True):
    extra = TUNED if remat else dict(fuse_ln=True)
    model = AlbefModel(albef_port_config(dataclasses.replace(cfg, **extra)), attn_impl="auto",
                       vision_attn_impl=vision)
    model.load_state_dict(albef_from_flax(weights), strict=True)
    return model


def test_tuned_albef_forward_matches_jax(albef_weights):
    batch = _train_batch(1)
    jmodel = JaxAlbef(dataclasses.replace(TINY, **TUNED), vision_attn_impl="layer")
    j_loss, j_logits = jax.jit(lambda p, b: jmodel.apply({"params": p}, b, adapter_mode="ensemble",
                                                         deterministic=True))(albef_weights, batch)
    for vision in ("layer", "block"):
        with torch.no_grad():
            loss, logits = port_albef(albef_weights, vision)(to_device(batch, torch.device("cpu")),
                                                             "ensemble", deterministic=True)
        np.testing.assert_allclose(float(loss), float(j_loss), **JAX_TOL)
        np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **JAX_TOL)


@pytest.fixture(scope="module")
def jax_tuned_grads(albef_weights):
    jmodel = JaxAlbef(dataclasses.replace(TINY, **TUNED), vision_attn_impl="layer")
    batch = _train_batch(3)
    return batch, _jax_first_step_grads(jmodel, albef_weights, batch, JaxOptimizerConfig(**OPT))


def _port_run(model, kind, batch, steps=2, seed=0):
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    opt = OptimizerConfig(**OPT)
    if kind == "standard":
        part = tdat.Partitioner(sd, "fed", PEFTMode.DAT)
        step = tdat.make_dat_train_step(make_albef_forward(model), part, opt, 100)
    else:
        step, part = trainers.make_albef_fused_dat_step(model, sd, opt, 100)
    state = tdat.init_train_state(sd, part, opt, torch.Generator().manual_seed(seed))
    out = []
    for _ in range(steps):
        state, m = step(state, to_device(batch, torch.device("cpu")))
        out.append(m)
    return out, state.params


@pytest.mark.parametrize("kind", ["standard", "fused"])
@pytest.mark.parametrize("vision", ["layer", "block"])
def test_tuned_albef_steps_match_jax_and_no_remat(albef_weights, jax_tuned_grads, vision, kind):
    """Dropout off: the first step's four gradient sets against JAX's tuned
    model (relative Frobenius error per set at most 1e-4, the rule of
    test_torch_albef_train.py), and two steps with remat equal to two without."""
    batch, jgrads = jax_tuned_grads
    runs, params = _port_run(port_albef(albef_weights, vision), kind, batch)
    assert set(runs[0]["grads"]) == set(jgrads)
    for name, g in jgrads.items():
        assert _rel(runs[0]["grads"][name], g) <= 1e-4, name
    plain, plain_params = _port_run(port_albef(albef_weights, vision, remat=False), kind, batch)
    for a, b in zip(runs, plain):
        for key in ("loss", "loss_shared"):
            np.testing.assert_allclose(float(a[key]), float(b[key]), **EXACT)
    for k, v in plain_params.items():
        np.testing.assert_allclose(params[k].numpy(), v.numpy(), err_msg=k, **EXACT)


def test_tuned_albef_live_dropout_remat_equals_no_remat(albef_weights):
    """ALBEF's 0.1 live in the BERT towers: the fused step with "names" remat
    gives the no-remat losses and parameters from the same state."""
    live = dataclasses.replace(TINY, bert=dataclasses.replace(TINY.bert, hidden_dropout=0.1,
                                                              attention_dropout=0.1))
    batch = _train_batch(5)
    runs = [_port_run(port_albef(albef_weights, "layer", live, remat=r), "fused", batch, seed=11)
            for r in (True, False)]
    for a, b in zip(runs[0][0], runs[1][0]):
        for key in ("loss", "loss_shared"):
            np.testing.assert_allclose(float(a[key]), float(b[key]), **EXACT)
    for k, v in runs[1][1].items():
        np.testing.assert_allclose(runs[0][1][k].numpy(), v.numpy(), err_msg=k, **EXACT)


def test_tuned_fused_loss_means_match_jax_by_distribution(albef_weights):
    """As test_torch_albef_train.py::test_fused_loss_means_match_jax_by_distribution,
    with both sides in the tuned configuration: dropout 0.3 live, the fused
    step's two losses over two steps from N seeds each, means within 4 pooled
    standard errors."""
    cfg = dataclasses.replace(TINY, bert=dataclasses.replace(TINY.bert, hidden_dropout=0.3,
                                                             attention_dropout=0.3))
    batch = _train_batch(8)
    n = 10
    jopt = JaxOptimizerConfig(**OPT)
    jstep, jpart = jax_make_albef_fused_dat_step(
        JaxAlbef(dataclasses.replace(cfg, **TUNED), vision_attn_impl="layer"), albef_weights, jopt, 100)
    model = port_albef(albef_weights, "layer", cfg)
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    opt = OptimizerConfig(**OPT)
    step, part = trainers.make_albef_fused_dat_step(model, sd, opt, 100)
    tbatch = to_device(batch, torch.device("cpu"))
    j, t = [], []
    for seed in range(n):
        js = jdat.init_train_state(albef_weights, jpart, jopt, jax.random.PRNGKey(100 + seed))
        ts = tdat.init_train_state(sd, part, opt, torch.Generator().manual_seed(100 + seed))
        row_j, row_t = [], []
        for _ in range(2):
            js, jm = jstep(js, batch)
            ts, tm = step(ts, tbatch)
            row_j += [float(jm["loss"]), float(jm["loss_shared"])]
            row_t += [float(tm["loss"]), float(tm["loss_shared"])]
        j.append(row_j)
        t.append(row_t)
    j, t = np.array(j), np.array(t)
    assert j.std(axis=0).min() > 1e-6 and t.std(axis=0).min() > 1e-6
    se = np.sqrt((j.var(axis=0) + t.var(axis=0)) / n)
    diff = np.abs(j.mean(axis=0) - t.mean(axis=0))
    assert (diff < 4 * se + 1e-7).all(), (diff, 4 * se)
