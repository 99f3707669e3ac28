"""The joint (mega-batched) DAT step of the port against the JAX package on
the CPU (``tests/conftest.py::TINY_VILT``, dropout off): the three cases of
tests/test_dat_joint.py through both packages (joint == standard over 3
steps, ``MODE_WEIGHTED`` with one-hot and ensemble rows == the static modes,
and JAX's ``_sched_total`` horizon, which the port takes as its step's
``max_steps``: only the JAX SPMD engine's full-epochs mode makes a
per-slot horizon), the port's joint step against JAX's joint
step, its four gradient sets against its standard step's, the
``adapter_scaling`` refusal with JAX's error, and the ``"layer"`` gate
sending the weighted rows the ``"block"`` way (#1/#3's route, never #4's).

Tolerances: tests/test_dat_joint.py's own within each package (losses rtol
1e-5, parameters rtol 2e-5 and atol 1e-7, weighted against static rtol 1e-6
and atol 1e-7); across the packages the rule of tests/test_torch_train.py,
losses rtol 2e-5, parameters rtol 1e-4 and atol lr/50, lr rtol 1e-6."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from feddat_tpu.configs.core import OptimizerConfig as JaxOptimizerConfig
from feddat_tpu.configs.core import PEFTMode as JaxPEFTMode
from feddat_tpu.train import dat as jdat
from feddat_tpu_torch.configs.core import OptimizerConfig, PEFTMode
from feddat_tpu_torch.models.layers import PreLNLayer
from feddat_tpu_torch.ops import attn_block as ab
from feddat_tpu_torch.train import dat as tdat
from feddat_tpu_torch.train import trainers
from feddat_tpu_torch.train.forwards import make_vilt_forward, make_vilt_fused_parts, to_device
from feddat_tpu_torch.train.optim import polynomial_schedule
from feddat_tpu_torch.utils.param_bridge import vilt_from_flax

from conftest import TINY_VILT, tiny_batch
from test_dat_joint import _make_joint as jax_make_joint
from test_torch_vilt import jax_model_and_params, port_model, to_torch

HEADS = {"coco": dict(num_labels=16)}
LR = 1e-2
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jax_vilt():
    return jax_model_and_params(TINY_VILT, heads=HEADS)


def _steps(model, sd, kinds=("standard", "joint"), max_steps=100):
    opt = OptimizerConfig(lr=LR)
    part = tdat.Partitioner(sd, "coco", PEFTMode.DAT)
    out = {}
    for kind in kinds:
        step = (tdat.make_dat_train_step(make_vilt_forward(model, "coco"), part, opt, max_steps)
                if kind == "standard"
                else trainers.make_vilt_joint_dat_step(model, "coco", part, opt, max_steps))
        out[kind] = (step, tdat.init_train_state(sd, part, opt, torch.Generator().manual_seed(0)))
    return out


def _sd(model):
    return {k: v.detach() for k, v in model.state_dict().items()}


def _run(steps, batch, n=3):
    runs = {}
    for kind, (step, state) in steps.items():
        metrics = []
        for _ in range(n):
            state, m = step(state, batch)
            metrics.append(m)
        runs[kind] = (state, metrics)
    return runs


def _close_params(got, want, rtol, atol, what):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=rtol, atol=atol, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("sched_total", [False, True], ids=["static", "sched_total"])
def test_joint_step_matches_standard_and_jax(jax_vilt, sched_total):
    """tests/test_dat_joint.py::test_joint_step_matches_standard (and
    ``..._with_sched_total``: JAX's per-slot horizon of 17, not
    max_steps=100, against the port's steps built with max_steps=17) through
    the port, and the port's joint step against JAX's joint step."""
    jmodel, params = jax_vilt
    batch = tiny_batch(np.random.RandomState(11 if sched_total else 5))
    if sched_total:
        batch = dict(batch, _sched_total=np.full((batch["input_ids"].shape[0],), 17, np.int32))
    jopt = JaxOptimizerConfig(lr=LR)
    jpart = jdat.Partitioner(params, "coco", JaxPEFTMode.DAT)
    jstep = jax_make_joint(jmodel, params, jpart)
    jstate = jdat.init_train_state(params, jpart, jopt, jax.random.PRNGKey(0))
    jlosses = []
    for _ in range(3):
        jstate, jm = jstep(jstate, batch)
        jlosses.append((float(jm["loss"]), float(jm["loss_shared"]), float(jm["lr"])))

    model = port_model(TINY_VILT, params, "auto", HEADS)
    tbatch = to_device({k: v for k, v in batch.items() if k != "_sched_total"}, CPU)
    runs = _run(_steps(model, _sd(model), max_steps=17 if sched_total else 100), tbatch)
    (s_std, m_std), (s_joint, m_joint) = runs["standard"], runs["joint"]
    for a, b, (jl, jls, jlr) in zip(m_std, m_joint, jlosses):
        np.testing.assert_allclose(float(b["loss"]), float(a["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(b["loss_shared"]), float(a["loss_shared"]), rtol=1e-5)
        np.testing.assert_allclose(b["lr"], a["lr"], rtol=1e-6)
        np.testing.assert_allclose(float(b["loss"]), jl, rtol=2e-5)
        np.testing.assert_allclose(float(b["loss_shared"]), jls, rtol=2e-5)
        np.testing.assert_allclose(b["lr"], jlr, rtol=1e-6)
    if sched_total:  # the horizon is 17, not 100: the last step's lr shows it
        assert abs(m_joint[-1]["lr"] - polynomial_schedule(OptimizerConfig(lr=LR), 100)(5)) > 1e-6
    _close_params(s_joint.params, s_std.params, 2e-5, 1e-7, "joint against standard")
    _close_params(s_joint.params, vilt_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params)),
                  1e-4, LR / 50, "joint against JAX's joint")
    assert s_joint.sched_count == s_std.sched_count == 6
    moved = [k for k, v in _sd(model).items() if not torch.equal(v, s_joint.params[k])]
    assert moved and all(any(t in k for t in ("adapter_0", "adapter_1", "task_coco")) for k in moved)


def test_joint_gradient_sets_equal_the_standard_steps(jax_vilt):
    """The one backward's four gradient sets (② adapter_1 and head, ③
    adapter_0 and head) against the standard step's three forwards."""
    model = port_model(TINY_VILT, jax_vilt[1], "auto", HEADS)
    runs = _run(_steps(model, _sd(model)), to_device(tiny_batch(np.random.RandomState(3)), CPU), n=1)
    g_std, g_joint = runs["standard"][1][0]["grads"], runs["joint"][1][0]["grads"]
    assert set(g_std) == set(g_joint) == {"shared", "head_2", "local", "head_3"}
    for name, g in g_std.items():
        _close_params(g_joint[name], g, 2e-5, 1e-8, name)


def test_weighted_adapter_mode_matches_static_modes_and_jax(jax_vilt):
    """tests/test_dat_joint.py::test_weighted_adapter_mode_matches_static_modes
    through the port, and the weighted pass against JAX's."""
    jmodel, params = jax_vilt
    batch = tiny_batch(np.random.RandomState(7))
    b = batch["input_ids"].shape[0]
    model = port_model(TINY_VILT, params, "auto", HEADS)
    encode = make_vilt_fused_parts(model, "coco")[0]
    sd = _sd(model)

    def enc(mode, weights=None):
        t = to_torch(batch)
        if weights is not None:
            t["adapter_weights"] = torch.tensor(weights).expand(b, -1)
        with torch.no_grad():
            return encode(sd, t, mode)

    for weights, static in (([0.0, 1.0, 0.0], "adapter_1"), ([0.5, 0.0, 0.5], "ensemble")):
        got = enc("weighted", weights)
        np.testing.assert_allclose(got.numpy(), enc(static).numpy(), rtol=1e-6, atol=1e-7)
        jb = dict(batch, adapter_weights=np.tile(np.asarray(weights, np.float32), (b, 1)))
        want = jax.jit(lambda p, x: jmodel.apply({"params": p}, "coco", x, adapter_mode="weighted",
                                                 deterministic=True,
                                                 method=type(jmodel).encode_single_image))(params, jb)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_joint_step_refuses_adapter_scaling(jax_vilt):
    """JAX's ValueError, word for word, before anything runs."""
    model = port_model(TINY_VILT, jax_vilt[1], "auto", HEADS)
    part = tdat.Partitioner(_sd(model), "coco", PEFTMode.DAT)
    parts = make_vilt_fused_parts(model, "coco")
    with pytest.raises(ValueError) as port_err:
        tdat.make_dat_train_step_joint(*parts, part, OptimizerConfig(lr=LR), 100, adapter_scaling=0.5)
    jpart = jdat.Partitioner(jax_vilt[1], "coco", JaxPEFTMode.DAT)
    with pytest.raises(ValueError) as jax_err:
        jdat.make_dat_train_step_joint(None, None, None, jpart, JaxOptimizerConfig(lr=LR), 100,
                                       adapter_scaling=0.5)
    assert str(port_err.value) == str(jax_err.value)
    assert "requires AdapterSpec.scaling == 1.0" in str(port_err.value)


def test_layer_gate_sends_weighted_rows_the_block_way(jax_vilt, monkeypatch, caplog):
    """On ``attn_impl="layer"`` a layer whose call carries per-example
    adapter weights is not the whole-layer kernel's (#4): the joint step's
    one pass runs every layer through the attention block (#1/#3's route),
    as JAX routes it, and gives the "auto" model's step."""
    calls = {"layer": 0, "block": 0}
    real_layer, real_block = PreLNLayer._layer_kernel, ab.attn_block

    def layer(self, *a, **kw):
        calls["layer"] += 1
        return real_layer(self, *a, **kw)

    def block(*a, **kw):
        calls["block"] += 1
        return real_block(*a, **kw)

    monkeypatch.setattr(PreLNLayer, "_layer_kernel", layer)
    monkeypatch.setattr(ab, "attn_block", block)
    batch = to_device(tiny_batch(np.random.RandomState(9)), CPU)
    states = {}
    for impl in ("layer", "auto"):
        model = port_model(TINY_VILT, jax_vilt[1], impl, HEADS)
        calls.update(layer=0, block=0)
        (step, state), = _steps(model, _sd(model), kinds=("joint",)).values()
        states[impl], _ = step(state, batch)
        if impl == "layer":
            assert calls == {"layer": 0, "block": TINY_VILT.num_layers}, calls
    _close_params(states["layer"].params, states["auto"].params, 1e-4, LR / 50, "layer against auto")
    # a model with live dropout: the joint pass drops it, with JAX's warning
    model = port_model(TINY_VILT, jax_vilt[1], "auto", HEADS)
    model.config = dataclasses.replace(model.config, hidden_dropout=0.1)
    with caplog.at_level("WARNING", logger="feddat_tpu_torch"):
        _steps(model, _sd(model), kinds=("joint",))
    assert any("joint DAT step drops dropout" in r.message for r in caplog.records)
