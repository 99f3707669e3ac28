"""The port's training pieces against the JAX package on the CPU, in float32:
losses, the schedules, the AdamW direction (against optax over several
steps), the roles and partitions (against ``label_params`` on the same tiny
ViLT), and the standard and fused DAT steps (per-step losses and updated
parameters over 3 steps, the port with ``attn_impl`` "auto" and "layer"
against the JAX steps on the composable path).

Tolerances: losses and schedules rtol=1e-6 (one fp32 formula); AdamW
rtol=1e-6, atol=1e-9 (elementwise, same order of operations); the DAT steps
rtol=2e-5 on the losses and rtol=1e-4, atol=1e-6 on the parameters — the
gradients are sums over the tiny model summed in another order, and Adam's
normalised update passes their relative error straight into the step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from feddat_tpu.configs.core import OptimizerConfig as JaxOptimizerConfig
from feddat_tpu.configs.core import PEFTMode as JaxPEFTMode
from feddat_tpu.peft import partition as jpart
from feddat_tpu.train import dat as jdat
from feddat_tpu.train import losses as jlosses
from feddat_tpu.train import optim as joptim
from feddat_tpu.train.forwards import make_vilt_forward as jax_make_vilt_forward
from feddat_tpu_torch.configs.core import OptimizerConfig, PEFTMode
from feddat_tpu_torch.peft import partition as tpart
from feddat_tpu_torch.train import dat as tdat
from feddat_tpu_torch.train import losses as tlosses
from feddat_tpu_torch.train import optim as toptim
from feddat_tpu_torch.train.forwards import make_vilt_forward, make_vilt_fused_parts, to_device
from feddat_tpu_torch.utils.param_bridge import _leaf, vilt_from_flax

from conftest import TINY_VILT, tiny_batch
from test_torch_vilt import jax_model_and_params, port_model

HEADS = {"coco": dict(num_labels=16)}
OPT = dict(lr=1e-2, weight_decay=1e-2)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_losses_match_jax():
    rng = np.random.RandomState(0)
    logits = rng.randn(5, 16).astype(np.float32) * 3
    other = rng.randn(5, 16).astype(np.float32) * 3
    target = (rng.rand(5, 16) > 0.8).astype(np.float32) * 0.9
    labels = rng.randint(0, 16, size=5)
    pairs = [
        (tlosses.bce_with_logits_vqa(_t(logits), _t(target)), jlosses.bce_with_logits_vqa(logits, target)),
        (tlosses.kd_kl_loss(_t(logits), _t(other)), jlosses.kd_kl_loss(logits, other)),
        (tlosses.cross_entropy(_t(logits), _t(labels)), jlosses.cross_entropy(logits, labels)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("max_steps,ratio", [(40, 0.1), (7, 0.3), (100, 0.0)])
def test_schedules_match_jax(max_steps, ratio):
    cfg = dict(lr=3e-4, warmup_ratio=ratio, power=1.0, lr_end=1e-6)
    t, j = toptim.polynomial_schedule(OptimizerConfig(**cfg), max_steps), \
        joptim.polynomial_schedule(JaxOptimizerConfig(**cfg), max_steps)
    td, jd = toptim.polynomial_schedule_dyn(OptimizerConfig(**cfg)), \
        joptim.polynomial_schedule_dyn(JaxOptimizerConfig(**cfg))
    for count in range(max_steps + 3):
        np.testing.assert_allclose(t(count), float(j(count)), rtol=1e-6)
        np.testing.assert_allclose(td(count, max_steps), float(jd(count, max_steps)), rtol=1e-6)


def test_adamw_direction_matches_optax_over_steps():
    """Four named leaves cover the decay mask: a bias, an embedding LN scale
    (no decay under the reference's ``LayerNorm.weight`` match), a layer LN
    scale and a dense kernel (both decayed)."""
    rng = np.random.RandomState(1)
    shapes = {("vilt", "text_embeddings", "norm", "scale"): (6,),
              ("vilt", "final_norm", "scale"): (6,),
              ("vilt", "pooler", "bias"): (6,),
              ("vilt", "pooler", "kernel"): (6, 6)}
    port_name = {k: ".".join(k[:-1] + ("weight" if k[-1] in ("scale", "kernel") else k[-1],))
                 for k in shapes}
    jp = traverse_util.unflatten_dict({k: jnp.asarray(rng.randn(*s).astype(np.float32))
                                       for k, s in shapes.items()})
    tp = {port_name[k]: _t(v) for k, v in traverse_util.flatten_dict(jp).items()}
    assert toptim._decay_mask(tp) == {
        "vilt.text_embeddings.norm.weight": False, "vilt.final_norm.weight": True,
        "vilt.pooler.bias": False, "vilt.pooler.weight": True}
    cfg = dict(lr=1e-2, weight_decay=0.1)
    jtx, ttx = joptim.adamw_direction(JaxOptimizerConfig(**cfg)), toptim.adamw_direction(OptimizerConfig(**cfg))
    js, ts = jtx.init(jp), ttx.init(tp)
    for step in range(4):
        grads = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
        lr = 1e-2 / (step + 1)
        jp, js = joptim.apply_direction(jtx, traverse_util.unflatten_dict(
            {k: jnp.asarray(v) for k, v in grads.items()}), js, jp, jnp.float32(lr))
        tp, ts = toptim.apply_direction(ttx, {port_name[k]: _t(v) for k, v in grads.items()}, ts, tp, lr)
    for k, v in traverse_util.flatten_dict(jp).items():
        np.testing.assert_allclose(tp[port_name[k]].numpy(), np.asarray(v), rtol=1e-6, atol=1e-9)
    assert ts.count == 4


def _port_names(path, value):
    """The port's state_dict names of one flax leaf (one per scanned layer)."""
    if path[:3] == ("vilt", "layers", "layer"):
        return [_leaf(("vilt", "layers", str(i)) + path[3:], value[i])[0] for i in range(value.shape[0])]
    return [_leaf(path, value)[0]]


@pytest.fixture(scope="module")
def tiny():
    jmodel, params = jax_model_and_params(TINY_VILT, heads=HEADS)
    return jmodel, params


def test_roles_and_partitions_match_jax(tiny):
    _, params = tiny
    sd = vilt_from_flax(params)
    labels = tpart.label_params(sd)
    jlabels = traverse_util.flatten_dict(jpart.label_params(params))
    flat = traverse_util.flatten_dict(params)
    mapped = {n: jlabels[p] for p, v in flat.items() for n in _port_names(p, v)}
    assert mapped == labels and len(set(labels.values())) >= 6
    for mode in (PEFTMode.DAT, PEFTMode.ADAPTER, PEFTMode.BIAS, PEFTMode.NORM, PEFTMode.FULL):
        jmode = JaxPEFTMode(mode.value)
        jb, tb = jpart.param_budget(params, jmode), tpart.param_budget(sd, mode)
        assert {k: jb[k] for k in ("total", "trainable", "communicated", "personal")} == \
            {k: tb[k] for k in ("total", "trainable", "communicated", "personal")}
        jp, tp = jdat.Partitioner(params, "coco", jmode), tdat.Partitioner(sd, "coco", mode)
        for attr in ("head_paths", "shared_paths", "local_paths"):
            want = {n for p in getattr(jp, attr) for n in _port_names(p, flat[p])}
            assert set(getattr(tp, attr)) == want, (mode, attr)
    refreshed = tpart.teacher_refresh(sd)
    key = "vilt.layers.1.adapter.adapter_2_up.weight"
    assert refreshed[key] is sd[key.replace("adapter_2", "adapter_1")]


def _jax_fused_step(jmodel, params, part, opt):
    labels = jpart.label_params(params)
    _, frozen_rest = jpart.split_by_roles(params, labels, frozenset({"head"}))

    def encode(p, b, mode, rng):
        return jmodel.apply({"params": p}, "coco", b, adapter_mode=mode, deterministic=True,
                            method=type(jmodel).encode_single_image)

    def head_fn(h, pooled):
        return jmodel.apply({"params": jpart.merge(h, frozen_rest)}, "coco", pooled,
                            method=type(jmodel).apply_head)

    def task_loss(logits, b):
        return jlosses.bce_with_logits_vqa(logits, b["target_scores"])

    return jdat.make_dat_train_step_fused(encode, head_fn, task_loss, part, opt, 100, donate=False)


@pytest.fixture(scope="module")
def jax_trajectories(tiny):
    """Losses and flattened parameters after each of 3 steps of the JAX
    standard and fused DAT steps (composable path), on one batch."""
    jmodel, params = tiny
    batch = tiny_batch(np.random.RandomState(5))
    batch["attention_mask"][0, 5:] = 0
    part = jdat.Partitioner(params, "coco", JaxPEFTMode.DAT)
    opt = JaxOptimizerConfig(**OPT)
    out = {}
    for name, step in (("standard", jdat.make_dat_train_step(
            jax_make_vilt_forward(jmodel, "coco"), part, opt, 100, donate=False)),
            ("fused", _jax_fused_step(jmodel, params, part, opt))):
        state = jdat.init_train_state(params, part, opt, jax.random.PRNGKey(0))
        traj = []
        for _ in range(3):
            state, m = step(state, batch)
            traj.append((float(m["loss"]), float(m["loss_shared"]),
                         jax.tree_util.tree_map(np.asarray, state.params)))
        out[name] = traj
    return batch, out


@pytest.mark.parametrize("kind", ["standard", "fused"])
@pytest.mark.parametrize("attn_impl", ["auto", "layer"])
def test_dat_steps_match_jax(tiny, jax_trajectories, kind, attn_impl, monkeypatch):
    _, params = tiny
    batch, want = jax_trajectories
    from feddat_tpu_torch.ops import layer_block as lb

    calls = []
    real = lb.layer_block
    monkeypatch.setattr(lb, "layer_block", lambda *a: calls.append(a[-3:]) or real(*a))
    model = port_model(TINY_VILT, params, attn_impl, HEADS)
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    part = tdat.Partitioner(sd, "coco", PEFTMode.DAT)
    opt = OptimizerConfig(**OPT)
    if kind == "standard":
        step = tdat.make_dat_train_step(make_vilt_forward(model, "coco"), part, opt, 100)
    else:
        step = tdat.make_dat_train_step_fused(*make_vilt_fused_parts(model, "coco"), part, opt, 100)
    state = tdat.init_train_state(sd, part, opt, torch.Generator().manual_seed(0))
    tbatch = to_device(batch, torch.device("cpu"))
    for loss, loss_shared, jparams in want[kind]:
        state, m = step(state, tbatch)
        np.testing.assert_allclose(float(m["loss"]), loss, rtol=2e-5)
        np.testing.assert_allclose(float(m["loss_shared"]), loss_shared, rtol=2e-5)
        expect = vilt_from_flax(jparams)
        for k, v in expect.items():
            np.testing.assert_allclose(state.params[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    assert state.sched_count == 6
    passes = 3 if kind == "standard" else 2  # encoder passes per step
    want_calls = 3 * passes * TINY_VILT.num_layers if attn_impl == "layer" else 0
    assert len(calls) == want_calls  # every layer of every pass takes the whole-layer route
    if calls:  # ensemble passes mix adapter_0 with the frozen adapter_2 (0.5/0.5)
        assert {c for c in calls} == {(0.5, 0.5, True), (1.0, 0.0, False)}
    moved = [k for k in sd if not torch.equal(sd[k], state.params[k])]
    assert moved and all(tpart._role_of_path(k) in ("shared", "local", "head") for k in moved)


def test_plain_step_matches_jax(tiny):
    """The single-update step of the non-DAT modes (here ``bias``: every
    bias, the LayerNorm biases and the head train) over 2 steps."""
    jmodel, params = tiny
    batch = tiny_batch(np.random.RandomState(6))
    jpart_ = jdat.Partitioner(params, "coco", JaxPEFTMode.BIAS)
    opt = JaxOptimizerConfig(**OPT)
    jstep = jdat.make_plain_train_step(jax_make_vilt_forward(jmodel, "coco"), jpart_, opt, 100,
                                       "none", donate=False)
    jstate = jdat.init_train_state(params, jpart_, opt, jax.random.PRNGKey(0))
    model = port_model(TINY_VILT, params, "auto", HEADS)
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    part = tdat.Partitioner(sd, "coco", PEFTMode.BIAS)
    step = tdat.make_plain_train_step(make_vilt_forward(model, "coco"), part, OptimizerConfig(**OPT),
                                      100, "none")
    state = tdat.init_train_state(sd, part, OptimizerConfig(**OPT), torch.Generator().manual_seed(0))
    for _ in range(2):
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, to_device(batch, torch.device("cpu")))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=2e-5)
    for k, v in vilt_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params)).items():
        np.testing.assert_allclose(state.params[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-6, err_msg=k)
    assert state.sched_count == 2 and set(state.opt_states) == {"trainable"}
