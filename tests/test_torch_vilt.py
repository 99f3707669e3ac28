"""The port's ViLT continual learner against the JAX model on the same
weights (CPU, float32, tiny widths).  Tolerance: rtol=1e-4, atol=1e-5, as in
tests/test_pallas_kernels.py — both sides compute the same fp32 function and
differ only in summation order."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from feddat_tpu.models.vilt import TaskHeadSpec as JaxHeadSpec
from feddat_tpu.models.vilt import ViltContinualLearner as JaxVilt
from feddat_tpu.models.vilt import init_vilt_params as jax_init_vilt_params
from feddat_tpu_torch.configs.core import (
    AdapterSpec,
    LoraSpec,
    PEFTMode,
    PromptSpec,
    ViltModelConfig,
)
from feddat_tpu_torch.models import create_model
from feddat_tpu_torch.models.vilt import TaskHeadSpec, ViltContinualLearner, init_vilt_params
from feddat_tpu_torch.utils.param_bridge import vilt_from_flax

from conftest import TINY_VILT, tiny_batch

RTOL, ATOL = 1e-4, 1e-5
HEADS = {
    "coco": dict(num_labels=16),
    "nlvr": dict(num_labels=2, num_images=2),
    "vcr": dict(num_labels=1, model_type="multi-choice", num_choices=3),
}


def port_config(jax_cfg) -> ViltModelConfig:
    """The JAX ViltModelConfig as the port's own dataclass (same fields)."""
    d = dataclasses.asdict(jax_cfg)
    d["adapter"] = AdapterSpec(**d["adapter"])
    d["lora"] = LoraSpec(**d["lora"])
    d["prompt"] = PromptSpec(**d["prompt"])
    return ViltModelConfig(**d)


def jax_model_and_params(jax_cfg, attn_impl="auto", heads=HEADS, seed=0):
    model = JaxVilt(jax_cfg, {k: JaxHeadSpec(**v) for k, v in heads.items()},
                    attn_impl=attn_impl)
    batch = tiny_batch(np.random.RandomState(seed), 2, cfg=jax_cfg)
    params = jax_init_vilt_params(model, jax.random.PRNGKey(seed), batch)
    return model, jax.tree_util.tree_map(np.asarray, params)


def port_model(jax_cfg, params, attn_impl="auto", heads=HEADS):
    model = ViltContinualLearner(port_config(jax_cfg),
                                 {k: TaskHeadSpec(**v) for k, v in heads.items()},
                                 attn_impl=attn_impl)
    model.load_state_dict(vilt_from_flax(params), strict=True)
    return model.eval()


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def run_both(jmodel, params, tmodel, task_key, batch, mode):
    _, jl = jax.jit(
        lambda p, b: jmodel.apply({"params": p}, task_key, b, adapter_mode=mode, deterministic=True)
    )(params, batch)
    with torch.no_grad():
        _, tl = tmodel(task_key, to_torch(batch), adapter_mode=mode)
    return np.asarray(jl), tl.numpy()


@pytest.fixture(scope="module")
def tiny_pair():
    jmodel, params = jax_model_and_params(TINY_VILT)
    return jmodel, params, port_model(TINY_VILT, params)


def test_param_bridge_uses_every_leaf_once(tiny_pair):
    _, params, tmodel = tiny_pair
    sd = vilt_from_flax(params)
    leaves = jax.tree_util.tree_leaves_with_path(params)
    n_expected = sum(
        leaf.shape[0] if "layers" in jax.tree_util.keystr(path) else 1 for path, leaf in leaves
    )
    assert len(sd) == n_expected == len(tmodel.state_dict())
    assert set(sd) == set(tmodel.state_dict())
    layer = params["vilt"]["layers"]["layer"]
    np.testing.assert_array_equal(
        sd["vilt.layers.1.attention.query.dense.weight"].numpy(),
        layer["attention"]["query"]["dense"]["kernel"][1].T,
    )
    np.testing.assert_array_equal(
        sd["vilt.visual_embeddings.patch_projection.weight"].numpy(),
        params["vilt"]["visual_embeddings"]["patch_projection"]["kernel"].transpose(3, 2, 0, 1),
    )


@pytest.mark.parametrize("mode", ["none", "adapter_0", "ensemble"])
def test_single_image_logits_match_jax(tiny_pair, mode):
    jmodel, params, tmodel = tiny_pair
    batch = tiny_batch(np.random.RandomState(1), 3)
    jl, tl = run_both(jmodel, params, tmodel, "coco", batch, mode)
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["none", "adapter_0", "ensemble"])
def test_block_fused_ln_logits_match_jax(mode):
    """attn_impl='block' + fuse_ln: JAX runs the Pallas kernel in interpret
    mode on the CPU, the port its plain attention-block version."""
    cfg = dataclasses.replace(TINY_VILT, fuse_ln=True)
    heads = {"coco": HEADS["coco"]}
    jmodel, params = jax_model_and_params(cfg, "block", heads)
    tmodel = port_model(cfg, params, "block", heads)
    mask = np.ones((3, cfg.max_text_len), np.int32)
    mask[0, 5:] = 0  # padded text keys reach the kernel as -10000 bias
    batch = dict(tiny_batch(np.random.RandomState(2), 3, cfg=cfg), attention_mask=mask)
    jl, tl = run_both(jmodel, params, tmodel, "coco", batch, mode)
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)


def test_u8_pixels_with_compact_mask_match_jax(tiny_pair):
    jmodel, params, tmodel = tiny_pair
    rng = np.random.RandomState(3)
    batch = tiny_batch(rng, 3)
    batch["pixel_values"] = rng.randint(0, 256, (3, 32, 32, 3)).astype(np.uint8)
    batch["pixel_mask"] = np.array([[32, 32], [20, 9], [7, 30]], np.int32)
    jl, tl = run_both(jmodel, params, tmodel, "coco", batch, "ensemble")
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)


def test_smaller_canvas_uses_position_subgrid(tiny_pair):
    jmodel, params, tmodel = tiny_pair
    rng = np.random.RandomState(4)
    batch = tiny_batch(rng, 2)
    batch["pixel_values"] = rng.randn(2, 32, 16, 3).astype(np.float32)
    jl, tl = run_both(jmodel, params, tmodel, "coco", batch, "adapter_0")
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)


def test_multi_image_and_multi_choice_match_jax(tiny_pair):
    jmodel, params, tmodel = tiny_pair
    rng = np.random.RandomState(5)
    b = tiny_batch(rng, 2)
    nlvr = dict(b, pixel_values=rng.randn(2, 2, 32, 32, 3).astype(np.float32))
    jl, tl = run_both(jmodel, params, tmodel, "nlvr", nlvr, "ensemble")
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    ids = rng.randint(1, 100, (2, 3, TINY_VILT.max_text_len)).astype(np.int32)
    vcr = dict(b, input_ids=ids, attention_mask=np.ones_like(ids))
    jl, tl = run_both(jmodel, params, tmodel, "vcr", vcr, "none")
    assert tl.shape == (2, 3)
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)


def test_seeded_init_follows_jax_scheme():
    cfg = dataclasses.replace(port_config(TINY_VILT), hidden_size=64, intermediate_size=128)

    def make(seed):
        model = ViltContinualLearner(cfg, {"t": TaskHeadSpec(16)})
        return init_vilt_params(model, seed).state_dict()

    sd, again, other = make(7), make(7), make(8)
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    assert not torch.equal(sd["vilt.pooler.weight"], other["vilt.pooler.weight"])
    assert torch.all(sd["vilt.layers.1.norm_before.weight"] == 1)
    assert torch.all(sd["vilt.layers.1.mlp.intermediate.bias"] == 0)
    assert torch.all(sd["vilt.visual_embeddings.position_embeddings"] == 0)
    std = sd["vilt.text_embeddings.word_embeddings.weight"].std().item()
    assert abs(std - 0.02) < 2e-3


def test_create_model_guards_and_device():
    with pytest.raises(ValueError, match="frozen attention projections"):
        create_model("vilt", {"t": TaskHeadSpec(2)}, PEFTMode.LORA, attn_impl="block",
                     device="cpu")
    model, _ = create_model("viltbert", {"t": TaskHeadSpec(2)}, PEFTMode.DAT, attn_impl="layer",
                            device="cpu", seed=None)
    assert type(model).__name__ == "ViltBertContinualLearner" and model.vilt.attn_impl == "layer"
    with pytest.raises(ValueError, match="fuses the \\(frozen\\) LayerNorms"):
        create_model("albef_distill", {}, PEFTMode.NORM, attn_impl="layer", device="cpu")
    with pytest.raises(ValueError, match="unknown encoder"):
        create_model("flava", {}, PEFTMode.DAT, device="cpu")
