"""The PEFT baselines of the port with ``attn_impl="fused"`` against the JAX
package's, on the CPU in float32 (``tests/conftest.py::TINY_VILT`` without
adapters; JAX runs kernels #5/#6 in interpret mode, the port their plain
versions): ``make_plain_train_step`` over 3 steps in modes lora (with a
non-zero ``lora_b`` drawn with numpy, so ``lora_a`` gets a gradient), bias,
full, norm, freeze_bottom_k_layers (k=1 of 2 layers), prompt, adapter (one
adapter, ``adapter_mode="adapter"``), freeze_encoder and none, and one
2-client FederatedTrainer round of LoRA with FedAvg of the LoRA factors.

Tolerances as tests/test_torch_train.py: losses rtol=2e-5, parameters
rtol=1e-4, atol=1e-6 (one fp32 function summed in another order; Adam's
normalised step passes the gradients' relative error into the update).  The
round: rtol=1e-4, atol=lr/50, as tests/test_torch_federated.py, for its
reason (an element whose gradient is near zero can move by up to a step of
size lr); its scores exactly.  One exception in the steps: ``attention.key.bias``
at atol=1e-5.  Its exact gradient is 0 (adding a constant per query row
leaves the softmax unchanged), so both sides move it by Adam-normalised
rounding noise, up to ~lr·|g|/eps per step with |g| ~ 1e-13: they read
~1e-7 and may differ by 1e-6."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from feddat_tpu.configs.core import AdapterSpec as JaxAdapterSpec
from feddat_tpu.configs.core import FederatedConfig as JaxFederatedConfig
from feddat_tpu.configs.core import LoraSpec as JaxLoraSpec
from feddat_tpu.configs.core import OptimizerConfig as JaxOptimizerConfig
from feddat_tpu.configs.core import PEFTMode as JaxPEFTMode
from feddat_tpu.configs.core import PromptSpec as JaxPromptSpec
from feddat_tpu.configs.core import TrainConfig as JaxTrainConfig
from feddat_tpu.data.synthetic import SyntheticVQAClient as JaxClient
from feddat_tpu.federated.engine import FederatedTrainer as JaxTrainer
from feddat_tpu.train import dat as jdat
from feddat_tpu.train.forwards import make_vilt_forward as jax_make_vilt_forward
from feddat_tpu_torch.configs.core import FederatedConfig, OptimizerConfig, PEFTMode, TrainConfig
from feddat_tpu_torch.data.synthetic import SyntheticVQAClient
from feddat_tpu_torch.federated.engine import FederatedTrainer
from feddat_tpu_torch.models.vilt import TaskHeadSpec, ViltContinualLearner, init_vilt_params
from feddat_tpu_torch.ops import attention as tattention
from feddat_tpu_torch.ops import fused_attention as fa
from feddat_tpu_torch.peft.partition import _role_of_path
from feddat_tpu_torch.train import dat as tdat
from feddat_tpu_torch.train.forwards import make_vilt_forward, to_device
from feddat_tpu_torch.utils.param_bridge import vilt_from_flax

from conftest import TINY_VILT, tiny_batch
from test_torch_vilt import jax_model_and_params, port_config, port_model

BASE = dataclasses.replace(TINY_VILT, adapter=JaxAdapterSpec())
LORA = JaxLoraSpec(rank=4, alpha=2.0, enabled=True)
HEADS = {"coco": dict(num_labels=16)}
OPT = dict(lr=1e-2, weight_decay=1e-2)
FREEZE_K = 1
# mode -> (config changes, the roles whose parameters must move)
MODES = {
    "lora": (dict(lora=LORA), {"lora", "head"}),
    "bias": ({}, {"bias", "norm_bias", "head"}),
    "full": ({}, {"backbone", "bias", "norm", "norm_bias", "head"}),
    "norm": ({}, {"norm", "norm_bias", "head"}),
    "freeze_bottom_k_layers": ({}, {"backbone", "bias", "norm", "norm_bias", "head"}),
    "prompt": (dict(prompt=JaxPromptSpec(length=3, bottleneck=8, enabled=True)), {"prompt", "head"}),
    "adapter": (dict(adapter=JaxAdapterSpec(names=("adapter",), reduction_factor=4)),
                {"shared", "head"}),
    "freeze_encoder": ({}, {"head"}),
    "none": ({}, {"head"}),
}


def with_drawn_lora_b(params, seed):
    """The JAX init leaves lora_b at zero, so lora_a's first gradient is exactly
    0; draw it from numpy so both factors train from the first step."""
    flat = traverse_util.flatten_dict(params)
    rng = np.random.RandomState(seed)
    for p in flat:
        if "lora_b" in p:
            flat[p] = (rng.randn(*flat[p].shape) * 0.1).astype(np.float32)
    return traverse_util.unflatten_dict(flat)


def counters(monkeypatch):
    """Count the port's fused-route forwards (per attention site) and the
    backward passes of its plain kernel version."""
    n = {"fwd": 0, "bwd": 0}
    real_route, real_bwd = tattention.fused_short_attention, fa.fused_attention_bwd_ref

    def route(*a):
        n["fwd"] += 1
        return real_route(*a)

    def bwd(*a):
        n["bwd"] += 1
        return real_bwd(*a)

    monkeypatch.setattr(tattention, "fused_short_attention", route)
    monkeypatch.setattr(fa, "fused_attention_bwd_ref", bwd)
    return n


@pytest.mark.parametrize("mode", list(MODES))
def test_plain_step_fused_route_matches_jax(mode, monkeypatch):
    changes, moving_roles = MODES[mode]
    cfg = dataclasses.replace(BASE, **changes)
    jmodel, params = jax_model_and_params(cfg, "fused", HEADS)
    params = with_drawn_lora_b(params, 3)
    batch = tiny_batch(np.random.RandomState(6), cfg=cfg)
    batch["attention_mask"][0, 5:] = 0  # padded keys reach the kernels as -10000 bias
    opt = JaxOptimizerConfig(**OPT)
    jpart = jdat.Partitioner(params, "coco", JaxPEFTMode(mode), layers_to_freeze=FREEZE_K)
    adapter_mode = "adapter" if mode == "adapter" else "none"
    jstep = jdat.make_plain_train_step(jax_make_vilt_forward(jmodel, "coco"), jpart, opt, 100,
                                       adapter_mode, donate=False)
    jstate = jdat.init_train_state(params, jpart, opt, jax.random.PRNGKey(0))

    n = counters(monkeypatch)
    model = port_model(cfg, params, "fused", HEADS)
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    part = tdat.Partitioner(sd, "coco", PEFTMode(mode), layers_to_freeze=FREEZE_K)
    step = tdat.make_plain_train_step(make_vilt_forward(model, "coco"), part, OptimizerConfig(**OPT),
                                      100, adapter_mode)
    state = tdat.init_train_state(sd, part, OptimizerConfig(**OPT), torch.Generator().manual_seed(0))
    tbatch = to_device(batch, torch.device("cpu"))
    for _ in range(3):
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, tbatch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=2e-5)
        for k, v in vilt_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params)).items():
            atol = 1e-5 if k.endswith("attention.key.bias") else 1e-6
            np.testing.assert_allclose(state.params[k].numpy(), v.numpy(), rtol=1e-4, atol=atol,
                                       err_msg=f"{mode}: {k}")

    layers = cfg.num_layers
    # the attention backward runs in the layers above the lowest trained
    # parameter: all of them, none when only the head trains, and above
    # layer 0 when the adapters (after each layer's attention) train
    trained_layers = {"freeze_bottom_k_layers": layers - FREEZE_K, "freeze_encoder": 0, "none": 0,
                      "adapter": layers - 1}.get(mode, layers)
    # every layer takes the fused route; autograd skips the frozen layers' backward
    assert n == {"fwd": 3 * layers, "bwd": 3 * trained_layers}
    moved = {k for k in sd if not torch.equal(sd[k], state.params[k])}
    assert {_role_of_path(k) for k in moved} == moving_roles
    if mode == "freeze_bottom_k_layers":
        frozen = {k for k in sd if "embeddings" in k or k.startswith("vilt.layers.0.")}
        assert frozen and not frozen & moved  # bit-equal to the start
        assert any(k.startswith("vilt.layers.1.") for k in moved)
        assert set(state.params) == set(sd) and part.shared_paths.isdisjoint(frozen)


CLIENT = dict(num_train=8, num_eval=8, num_labels=16, vocab_size=TINY_VILT.vocab_size,
              text_len=TINY_VILT.max_text_len, image_size=TINY_VILT.image_size, batch_size=4)
CLIENT_HEADS = {f"c{i}": dict(num_labels=16) for i in range(2)}
ROUND_LR = 5e-3


def test_lora_round_matches_jax_engine(monkeypatch):
    """One round of 2 clients x 2 steps: the server's LoRA factors after FedAvg,
    each client's personal head, and the scores of ``evaluate``."""
    cfg = dataclasses.replace(BASE, lora=LORA)
    jmodel, params = jax_model_and_params(cfg, "fused", CLIENT_HEADS)
    params = with_drawn_lora_b(params, 4)

    def config(mod):
        return mod["TrainConfig"](
            peft_mode=mod["PEFTMode"].LORA, optimizer=mod["OptimizerConfig"](lr=ROUND_LR),
            federated=mod["FederatedConfig"](comm_rounds=1, local_epochs=1, eval_every=1),
            num_epochs=2, seed=0)

    jt = JaxTrainer(jmodel, params, {k: JaxClient(k, seed=i, **CLIENT) for i, k in enumerate(CLIENT_HEADS)},
                    config(dict(TrainConfig=JaxTrainConfig, PEFTMode=JaxPEFTMode,
                                OptimizerConfig=JaxOptimizerConfig, FederatedConfig=JaxFederatedConfig)))
    jt.run(resume=False)

    n = counters(monkeypatch)
    tt = FederatedTrainer(port_model(cfg, params, "fused", CLIENT_HEADS), None,
                          {k: SyntheticVQAClient(k, seed=i, **CLIENT) for i, k in enumerate(CLIENT_HEADS)},
                          config(dict(TrainConfig=TrainConfig, PEFTMode=PEFTMode,
                                      OptimizerConfig=OptimizerConfig, FederatedConfig=FederatedConfig)),
                          device="cpu")
    tt.run()
    layers = cfg.num_layers
    # 2 clients x 2 steps (forward + backward), then 2 eval batches per client (forward)
    assert n == {"fwd": (2 * 2 + 2 * 2) * layers, "bwd": 2 * 2 * layers}

    def close(got, want_tree, what):
        want = vilt_from_flax(jax.tree_util.tree_map(np.asarray, want_tree))
        assert set(got) == set(want) and got, what
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4,
                                       atol=ROUND_LR / 50, err_msg=f"{what}: {k}")

    flat = traverse_util.flatten_dict(jt.server_params)
    close({k: v for k, v in tt.server_params.items() if "lora_" in k},
          traverse_util.unflatten_dict({p: v for p, v in flat.items() if "lora_a" in p or "lora_b" in p}),
          "server LoRA factors")
    moved = [k for k in tt.server_params if "lora_" in k and not torch.equal(
        tt.server_params[k], vilt_from_flax(params)[k])]
    assert len(moved) == 4 * layers  # lora_a and lora_b of query and value in every layer
    for key in CLIENT_HEADS:
        close(tt.personal[key], jt.personal[key], f"{key} personal")
    assert len(tt.history) == len(jt.history) == 1
    for key in CLIENT_HEADS:
        np.testing.assert_allclose(tt.history[0]["scores"][key], jt.history[0]["scores"][key],
                                   rtol=0, atol=1e-9)


def test_prompt_inits_follow_jax():
    """``init_vilt_params`` draws the prompt MLPs from the JAX inits'
    distributions (prompts.py:33-44): embedding N(0, 1), Linear weights and
    biases U(±1/√fan_in); the bridge maps every JAX prompt leaf onto them."""
    jcfg = dataclasses.replace(BASE, hidden_size=64, intermediate_size=128,
                               prompt=JaxPromptSpec(length=32, bottleneck=16, enabled=True))
    sd = init_vilt_params(ViltContinualLearner(port_config(jcfg), {"coco": TaskHeadSpec(16)}), 0).state_dict()
    jsd = vilt_from_flax(jax_model_and_params(jcfg, heads=HEADS)[1])
    assert set(jsd) == set(sd)
    for stream in ("text", "vis"):
        pre = f"vilt.prompt_{stream}."
        for got in (sd, jsd):
            emb = got[pre + "prompt_embed.weight"]
            assert emb.shape == (32, 64) and abs(emb.std().item() - 1.0) < 0.1
            for name, fan_in in (("prompt_down", 64), ("prompt_up", 16)):
                for leaf in ("weight", "bias"):
                    t = got[f"{pre}{name}.{leaf}"].abs().max().item()
                    assert 0.8 * fan_in ** -0.5 < t <= fan_in ** -0.5, (name, leaf, t)
