"""One plain train step of every non-DAT PEFT mode on tiny ALBEF, the port
against the JAX package on the CPU (the first five here, the other four in
tests/test_torch_albef_prompt.py): adapter, full, norm, bias, lora (its
``lora_b`` drawn non-zero), prompt (the visual prompt after the ViT's CLS),
freeze_encoder, none and freeze_bottom_k_layers (k=3: the ViT's two blocks,
the text encoder's two text layers and, counted from the text depth, the
first fusion layer of the encoder and of the decoder), dropout off: the port with
``attn_impl="flash"`` (the plain versions of #7-#9) against JAX's composable
path, one function (tests/test_torch_albef_train.py holds JAX's flash route
against its composable one).  Weights are drawn with numpy into the tree
``jax.eval_shape`` gives JAX's init, so no JAX init compiles.

Tolerances as tests/test_torch_albef_train.py's steps: the loss rtol=2e-5,
every parameter rtol=1e-4, atol=lr/50 (Adam turns the summation noise of a
near-zero gradient element into up to a step of size lr); and the set of
parameters that moved equal to JAX's.  One exception: the attention key
biases, held at atol=lr.  Their exact gradient is 0 (a constant added to a
query row's logits leaves its softmax unchanged), so both sides move them by
Adam-normalised rounding noise, up to one step of size lr, in the modes that
train them (full, bias, freeze_bottom_k_layers)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from feddat_tpu.configs.core import AdapterSpec as JaxAdapterSpec
from feddat_tpu.configs.core import LoraSpec as JaxLoraSpec
from feddat_tpu.configs.core import OptimizerConfig as JaxOptimizerConfig
from feddat_tpu.configs.core import PEFTMode as JaxPEFTMode
from feddat_tpu.configs.core import PromptSpec as JaxPromptSpec
from feddat_tpu.models.albef import AlbefModel as JaxAlbef
from feddat_tpu.train import dat as jdat
from feddat_tpu.train.forwards import make_albef_forward as jax_make_albef_forward
from feddat_tpu_torch.configs.core import OptimizerConfig, PEFTMode
from feddat_tpu_torch.models.albef import AlbefModel
from feddat_tpu_torch.train import dat as tdat
from feddat_tpu_torch.train.forwards import make_albef_forward, to_device
from feddat_tpu_torch.utils.param_bridge import albef_from_flax

from test_torch_albef import TINY, port_config
from test_torch_albef_train import _train_batch
from test_torch_remat import random_like_init

OPT = dict(lr=1e-2, weight_decay=1e-2, warmup_ratio=0.0)  # the first step moves
FREEZE_K = 3
NO_ADAPTER = dataclasses.replace(TINY, adapter=JaxAdapterSpec())
# mode -> (config, the adapter mode of the step)
MODES = {
    "adapter": (dataclasses.replace(TINY, adapter=JaxAdapterSpec(names=("adapter",),
                                                                 reduction_factor=4)), "adapter"),
    "full": (NO_ADAPTER, "none"),
    "norm": (NO_ADAPTER, "none"),
    "bias": (NO_ADAPTER, "none"),
    "lora": (dataclasses.replace(NO_ADAPTER, lora=JaxLoraSpec(rank=4, alpha=2.0, enabled=True)), "none"),
    "prompt": (dataclasses.replace(NO_ADAPTER, prompt=JaxPromptSpec(length=3, bottleneck=8,
                                                                    enabled=True)), "none"),
    "freeze_encoder": (NO_ADAPTER, "none"),
    "none": (NO_ADAPTER, "none"),
    "freeze_bottom_k_layers": (NO_ADAPTER, "none"),
}


def _weights(cfg, seed):
    batch = _train_batch(0)
    abstract = jax.eval_shape(lambda: JaxAlbef(cfg).init(
        jax.random.PRNGKey(0), batch, adapter_mode="init_all", deterministic=True))["params"]
    return random_like_init(abstract, seed)


def _port(tree):
    return albef_from_flax(jax.tree_util.tree_map(np.asarray, tree))


def check_plain_step(mode):
    """One plain step of ``mode`` against JAX's (the module docstring)."""
    cfg, adapter_mode = MODES[mode]
    weights = _weights(cfg, 5)
    batch = _train_batch(9)
    jopt = JaxOptimizerConfig(**OPT)
    jpart = jdat.Partitioner(weights, "fed", JaxPEFTMode(mode), layers_to_freeze=FREEZE_K)
    jstep = jdat.make_plain_train_step(jax_make_albef_forward(JaxAlbef(cfg)), jpart,
                                       jopt, 100, adapter_mode, donate=False)
    jstate, jm = jstep(jdat.init_train_state(weights, jpart, jopt, jax.random.PRNGKey(0)), batch)

    model = AlbefModel(port_config(cfg), attn_impl="flash")
    model.load_state_dict(albef_from_flax(weights), strict=True)
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    opt = OptimizerConfig(**OPT)
    part = tdat.Partitioner(sd, "fed", PEFTMode(mode), layers_to_freeze=FREEZE_K)
    step = tdat.make_plain_train_step(make_albef_forward(model), part, opt, 100, adapter_mode)
    state, m = step(tdat.init_train_state(sd, part, opt, torch.Generator().manual_seed(0)),
                    to_device(batch, torch.device("cpu")))

    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=2e-5)
    want = _port(jstate.params)
    assert set(want) == set(state.params)
    for k, v in want.items():
        atol = OPT["lr"] if k.endswith("attention.key.bias") else OPT["lr"] / 50
        np.testing.assert_allclose(state.params[k].numpy(), v.numpy(), rtol=1e-4, atol=atol,
                                   err_msg=f"{mode}: {k}")
    init = albef_from_flax(weights)
    moved = {k for k in sd if not torch.equal(init[k], state.params[k])}
    assert moved == {k for k in init if not torch.equal(init[k], want[k])}, mode
    assert moved and moved <= part.shared_paths | part.head_paths
    if mode in ("none", "freeze_encoder"):
        assert moved and all(".cls." in k for k in moved)
    if mode == "freeze_bottom_k_layers":
        flat = traverse_util.flatten_dict(jpart.grad_mask)
        assert flat  # JAX masks the stacks; the port leaves the frozen layers out
        frozen = {k for k in sd if "embeddings" in k or k.startswith((
            "visual_encoder.blocks.", "visual_encoder.patch_embed", "visual_encoder.pos_embed",
            "visual_encoder.cls_token", "text_encoder.encoder.text_layers.",
            "text_encoder.encoder.fusion_layers.0.", "text_decoder.bert.encoder.fusion_layers.0."))}
        assert frozen and not frozen & moved
        for tower in ("text_encoder.encoder", "text_decoder.bert.encoder"):
            assert any(k.startswith(f"{tower}.fusion_layers.1.") for k in moved)


@pytest.mark.parametrize("mode", ["adapter", "full", "norm", "bias", "lora"])
def test_plain_step_matches_jax(mode):
    check_plain_step(mode)
