"""ALBEF momentum distillation (``albef_distill``) of the port against the
JAX package on the CPU (tiny widths, adapter mode, weights drawn with numpy
into the tree ``jax.eval_shape`` gives JAX's init): ``add_alpha``'s ramp value
for value, the in-place EMA bitwise JAX's expression, the distill forward
(loss, logits, the updated twin), three plain distill steps (losses, the
trainable parameters and the whole twin), the compiled step keeping the twin
resident without copying it and without a capture per alpha, the flash
forward keeping nothing under ``no_grad``.  The engine round and the
dropout-live distribution are in tests/test_torch_albef_distill_engine.py.

Tolerances: forwards fp32 rtol=1e-4, atol=1e-5 (one fp32 function summed in
another order), the twin a forward updated within one fp32 ulp of jitted
JAX's (XLA may fuse the EMA's product and sum); steps as
tests/test_torch_albef_train.py: losses rtol=2e-5, parameters and the twin
rtol=1e-4, atol=lr/50.  ``add_alpha``, and the EMA against JAX's expression
run op by op, exactly."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from feddat_tpu.configs.core import AdapterSpec as JaxAdapterSpec
from feddat_tpu.configs.core import OptimizerConfig as JaxOptimizerConfig
from feddat_tpu.configs.core import PEFTMode as JaxPEFTMode
from feddat_tpu.models.albef import AlbefModel as JaxAlbef
from feddat_tpu.models.albef import momentum_update as jax_momentum_update
from feddat_tpu.train import dat as jdat
from feddat_tpu.train.forwards import add_alpha as jax_add_alpha
from feddat_tpu.train.forwards import make_albef_distill_forward as jax_distill_forward
from feddat_tpu_torch.configs.core import OptimizerConfig, PEFTMode
from feddat_tpu_torch.models.albef import AlbefModel, momentum_update_
from feddat_tpu_torch.ops.flash import flash_attention
from feddat_tpu_torch.train import compiled
from feddat_tpu_torch.train import dat as tdat
from feddat_tpu_torch.train.forwards import add_alpha, make_albef_distill_forward, to_device
from feddat_tpu_torch.utils.param_bridge import albef_from_flax

from test_torch_albef import TINY, port_config
from test_torch_albef_train import _train_batch
from test_torch_remat import random_like_init

RTOL, ATOL = 1e-4, 1e-5
LR = 1e-2
DISTILL = dataclasses.replace(TINY, distill=True,
                              adapter=JaxAdapterSpec(names=("adapter",), reduction_factor=4))
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def weights():
    batch = _train_batch(0)
    abstract = jax.eval_shape(lambda: JaxAlbef(DISTILL).init(
        jax.random.PRNGKey(0), batch, adapter_mode="init_all", deterministic=True))["params"]
    return random_like_init(abstract, 3)


def _perturbed(weights, seed):
    """A twin that differs from the parameters (so the EMA and the soft
    labels are not trivial)."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda v: (v + rng.normal(0.0, 0.02, v.shape)).astype(np.float32), weights)


def _model(weights, cfg=DISTILL, attn_impl="flash"):
    model = AlbefModel(port_config(cfg), attn_impl=attn_impl)
    model.load_state_dict(albef_from_flax(weights), strict=True)
    return model


def _sd(model):
    return {k: v.detach() for k, v in model.state_dict().items()}


def _port(tree):
    return albef_from_flax(jax.tree_util.tree_map(np.asarray, tree))


@pytest.mark.parametrize("epoch,step,spe", [(0, 0, 4), (0, 1, 4), (0, 3, 3), (0, 5, 4), (0, 2, 0),
                                            (0, 7, 9), (1, 0, 4), (3, 2, 5)])
def test_add_alpha_ramp_matches_jax(epoch, step, spe):
    batch = {"x": np.zeros(2, np.float32)}
    want = jax_add_alpha(batch, epoch, step, spe)
    got = add_alpha(batch, epoch, step, spe)
    assert got["x"] is batch["x"] and set(got) == {"x", "alpha"} and "alpha" not in batch
    assert got["alpha"].dtype == torch.float32 and got["alpha"].dim() == 0
    assert got["alpha"].item() == float(np.float32(want["alpha"]))


def test_in_place_momentum_update_is_jax_bitwise():
    """Every tensor: JAX's ``m·0.995 + p·(1 − 0.995)``, bit for bit, written
    into the twin's own tensors."""
    rng = np.random.RandomState(1)
    p = {f"t{i}": rng.randn(*s).astype(np.float32) for i, s in enumerate([(64, 33), (7,), (300, 5)])}
    m = {k: rng.randn(*v.shape).astype(np.float32) for k, v in p.items()}
    want = jax_momentum_update(p, m, 0.995)
    twin = {k: torch.from_numpy(v.copy()) for k, v in m.items()}
    ids = {k: id(v) for k, v in twin.items()}
    out = momentum_update_({k: torch.from_numpy(v) for k, v in p.items()}, twin, 0.995)
    assert out is twin and {k: id(v) for k, v in out.items()} == ids
    for k in p:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(want[k]))


def test_distill_forward_matches_jax(weights):
    """Dropout off: the forward EMA-updates the twin from the parameters,
    takes the twin's soft labels and mixes them at alpha."""
    batch = dict(_train_batch(2), alpha=np.float32(0.3))
    aux = _perturbed(weights, 4)
    j_loss, j_logits, j_aux = jax.jit(jax_distill_forward(JaxAlbef(DISTILL)), static_argnums=2)(
        weights, batch, "adapter", jax.random.PRNGKey(0), aux)
    model = _model(weights)
    twin = _port(aux)
    t = to_device(batch, CPU)
    gens = (torch.Generator().manual_seed(1), torch.Generator().manual_seed(2))
    loss, logits, new = make_albef_distill_forward(model)(_sd(model), t, "adapter", gens, twin)
    assert new is twin
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=RTOL)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(j_logits), rtol=RTOL, atol=ATOL)
    for k, v in _port(j_aux).items():  # jitted, XLA may contract the EMA into an fma: one ulp
        np.testing.assert_allclose(new[k].numpy(), v.numpy(), rtol=2e-7, atol=1e-9, err_msg=k)
    # alpha 0 without soft labels is the no-distill loss
    with torch.no_grad():
        plain, _ = model(t, "adapter", deterministic=True)
    zero, _, _ = make_albef_distill_forward(model)(_sd(model), dict(t, alpha=torch.tensor(0.0)),
                                                 "adapter", gens, _port(aux))
    np.testing.assert_allclose(float(zero), float(plain), rtol=1e-6)


def _jax_steps(weights, cfg, batch, n, seed=0, spe=4):
    opt = JaxOptimizerConfig(lr=LR)
    model = JaxAlbef(cfg)
    part = jdat.Partitioner(weights, "fed", JaxPEFTMode.ADAPTER)
    step = jdat.make_plain_train_step(jax_distill_forward(model), part, opt, 100, "adapter",
                                      donate=False, aux_forward=True)
    state = jdat.init_train_state(weights, part, opt, jax.random.PRNGKey(seed)).replace(aux=weights)
    out = []
    for i in range(n):
        state, m = step(state, jax_add_alpha(batch, 0, i, spe))
        out.append((float(m["loss"]), state))
    return out


def _port_step(model, sd):
    opt = OptimizerConfig(lr=LR)
    part = tdat.Partitioner(sd, "fed", PEFTMode.ADAPTER)
    step = tdat.make_plain_train_step(make_albef_distill_forward(model), part, opt, 100, "adapter",
                                      aux_forward=True)
    return step, part, opt


def test_plain_distill_steps_match_jax(weights):
    """Three steps with alpha ramping 0, 0.1, 0.2: the losses, every
    parameter and the whole twin (frozen tensors included: their twin
    moves towards them by the EMA) against JAX's, and only the adapters and
    the head trained."""
    batch = _train_batch(3)
    want = _jax_steps(weights, DISTILL, batch, 3)
    model = _model(weights)
    sd = _sd(model)
    step, part, opt = _port_step(model, sd)
    state = tdat.init_train_state(sd, part, opt, torch.Generator().manual_seed(0)).replace(aux=dict(sd))
    tbatch = to_device(batch, CPU)
    for i, (loss, jstate) in enumerate(want):
        state, m = step(state, add_alpha(tbatch, 0, i, 4))
        np.testing.assert_allclose(float(m["loss"]), loss, rtol=2e-5)
        for what, got, tree in (("params", state.params, jstate.params), ("twin", state.aux, jstate.aux)):
            want_sd = _port(tree)
            assert set(got) == set(want_sd)
            for k, v in want_sd.items():
                np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4, atol=LR / 50,
                                           err_msg=f"step {i} {what}: {k}")
    assert state.sched_count == 3
    moved = [k for k in sd if not torch.equal(sd[k], state.params[k])]
    assert moved and all(".adapter." in k or ".cls." in k for k in moved)
    # the twin moved everywhere the parameters differ from it, frozen tensors included
    assert torch.equal(sd["visual_encoder.patch_embed.weight"],
                       state.params["visual_encoder.patch_embed.weight"])
    assert all(k in set(state.aux) for k in sd)


def test_compiled_step_keeps_the_twin_resident(weights):
    """The twin enters once: after the first step the state holds the
    program's own tensors, which the next step updates in place and hands
    back as themselves; the parameters the twin was seeded from never
    change; alpha, a 0-dim tensor, keys no new signature while it ramps; the
    eager path (``disable_graphs``) keeps the same rule, copying the twin it
    is first given and updating in place the one it handed back, and
    computes what the program computes."""
    model = _model(weights)
    sd = _sd(model)
    snapshot = {k: v.clone() for k, v in sd.items()}
    step, part, opt = _port_step(model, sd)
    tbatch = to_device(_train_batch(5), CPU)
    state = tdat.init_train_state(sd, part, opt, torch.Generator().manual_seed(0)).replace(aux=dict(sd))
    first = state
    states = []
    for i in range(3):
        state, _ = step(state, add_alpha(tbatch, 0, i, 4))
        states.append(state)
    assert all(torch.equal(sd[k], snapshot[k]) for k in sd)  # the seed's tensors untouched
    assert len(step.program.entries) == 1
    ids = [{k: id(v) for k, v in s.aux.items()} for s in states]
    assert ids[0] == ids[1] == ids[2]
    assert all(states[0].aux[k] is not first.aux[k] for k in sd)
    entry = next(iter(step.program.entries.values()))
    assert all(any(b is t for b in entry.bufs) for t in states[2].aux.values())

    eager_state = first
    with compiled.disable_graphs():
        for i in range(3):
            held = eager_state.aux
            eager_state, _ = step(eager_state, add_alpha(tbatch, 0, i, 4))
            assert all((eager_state.aux[k] is held[k]) == (i > 0) for k in sd)
    assert all(torch.equal(sd[k], snapshot[k]) for k in sd)
    for k in sd:
        np.testing.assert_array_equal(eager_state.aux[k].numpy(), states[2].aux[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(eager_state.params[k].numpy(), states[2].params[k].numpy(),
                                      err_msg=k)


def test_flash_forward_without_grad_saves_nothing():
    """The twin's forward calls flash attention with gradients off: it gets
    the same output and no autograd node, and nothing is packed for a
    backward."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 2, 9, 64, generator=g, requires_grad=True) for _ in range(3))
    packed = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: packed.append(t) or t, lambda t: t):
        with torch.no_grad():
            out = flash_attention(q, k, v)
        assert not packed and out.grad_fn is None and not out.requires_grad
        ref = flash_attention(q, k, v)
        assert packed and ref.grad_fn is not None
    assert torch.equal(out, ref.detach())
