"""Visual prompt tuning on ALBEF and ``XBertMaskedLM`` of the port against
the JAX package on the CPU (tiny widths, weights drawn with numpy into the
tree ``jax.eval_shape`` gives JAX's init), and the plain steps of the last
four non-DAT modes (tests/test_torch_albef_modes.py holds the first five):

* the prompt (``prompt_vis``, after the ViT's CLS token, so the fusion
  layers' cross-attention sees S + P image tokens): the parameter bridge,
  ``encode_question`` and ``rank_answer`` with ``attn_impl`` "auto" and
  "flash" (JAX's Pallas flash kernel in interpret mode, the port's plain
  version, at key lengths that are not a multiple of a tile);
* ``XBertMaskedLM`` (tests/test_albef.py::test_xbert_masked_lm_smoke's
  case): the logits with and without cross-attention to encoder states, the
  masked-LM loss with and without the soft-label mix;
* one plain step of prompt, freeze_encoder, none and freeze_bottom_k_layers.

Tolerance: fp32 rtol=1e-4, atol=1e-5 (one fp32 function summed in another
order); ranked answer ids equal.  The steps as tests/test_torch_albef_modes.py."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from feddat_tpu.configs.core import AdapterSpec as JaxAdapterSpec
from feddat_tpu.configs.core import AlbefBertConfig as JaxBertConfig
from feddat_tpu.configs.core import PromptSpec as JaxPromptSpec
from feddat_tpu.models.albef import AlbefModel as JaxAlbef
from feddat_tpu.models.xbert import XBertMaskedLM as JaxMaskedLM
from feddat_tpu_torch.configs.core import AdapterSpec, AlbefBertConfig
from feddat_tpu_torch.models.albef import AlbefModel
from feddat_tpu_torch.models.xbert import XBertMaskedLM
from feddat_tpu_torch.utils.param_bridge import albef_from_flax, xbert_mlm_from_flax

from test_torch_albef import LQ, TINY, _bank, _batch, _jax_apply, port_config, to_torch
from test_torch_albef_modes import check_plain_step
from test_torch_albef_train import _train_batch
from test_torch_remat import random_like_init

RTOL, ATOL = 1e-4, 1e-5
PROMPT = dataclasses.replace(TINY, prompt=JaxPromptSpec(length=5, bottleneck=8, enabled=True))


@pytest.fixture(scope="module")
def weights():
    abstract = jax.eval_shape(lambda: JaxAlbef(PROMPT).init(
        jax.random.PRNGKey(0), _train_batch(0), adapter_mode="init_all", deterministic=True))["params"]
    return random_like_init(abstract, 7)


def _model(weights, attn_impl):
    model = AlbefModel(port_config(PROMPT), attn_impl=attn_impl)
    model.load_state_dict(albef_from_flax(weights), strict=True)
    return model.eval()


def test_prompt_bridge_and_splice(weights):
    """``prompt_vis`` maps leaf for leaf; the question encoder's
    cross-attention keys are the ViT's S tokens and the P prompt tokens."""
    sd = albef_from_flax(weights)
    model = _model(weights, "auto")
    assert set(sd) == set(model.state_dict())
    prompt = {k for k in sd if k.startswith("prompt_vis.")}
    assert prompt == {f"prompt_vis.{m}.{leaf}" for m, leaf in (
        ("prompt_embed", "weight"), ("prompt_down", "weight"), ("prompt_down", "bias"),
        ("prompt_up", "weight"), ("prompt_up", "bias"))}
    np.testing.assert_array_equal(sd["prompt_vis.prompt_down.weight"].numpy(),
                                  weights["prompt_vis"]["prompt_down"]["kernel"].T)
    seen = []
    layer = model.text_encoder.encoder.fusion_layers[0].crossattention
    hook = layer.register_forward_hook(lambda m, a, kw, out: seen.append(kw["kv"].shape),
                                       with_kwargs=True)
    with torch.no_grad():
        model.encode_question(*(to_torch(_batch(np.random.RandomState(1), 2)).values()))
    hook.remove()
    s = (PROMPT.image_res // PROMPT.patch_size) ** 2 + 1
    assert seen == [(2, s + PROMPT.prompt.length, PROMPT.vision_width)]


@pytest.mark.parametrize("attn_impl", ["auto", "flash"])
def test_prompt_encode_question_matches_jax(weights, attn_impl):
    batch = _batch(np.random.RandomState(2), 3)
    want = _jax_apply(JaxAlbef.encode_question, batch["pixel_values"], batch["question_ids"],
                      batch["question_mask"], "none", attn_impl=attn_impl, params=weights, cfg=PROMPT)
    t = to_torch(batch)
    with torch.no_grad():
        got = _model(weights, attn_impl).encode_question(t["pixel_values"], t["question_ids"],
                                                         t["question_mask"], "none")
    assert got.shape == (3, LQ, PROMPT.bert.hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("attn_impl", ["auto", "flash"])
def test_prompt_rank_answer_matches_jax(weights, attn_impl):
    batch = _batch(np.random.RandomState(3), 3)
    ids, mask = _bank()
    want_ids, want_p = _jax_apply(JaxAlbef.rank_answer, batch, ids, mask, 12, "none",
                                  attn_impl=attn_impl, params=weights, cfg=PROMPT)
    with torch.no_grad():
        got_ids, got_p = _model(weights, attn_impl).rank_answer(
            to_torch(batch), torch.from_numpy(ids), torch.from_numpy(mask), 12, "none")
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=RTOL, atol=ATOL)


MLM_BERT = dict(vocab_size=100, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                hidden_dropout=0.0, attention_dropout=0.0, fusion_layer=1)


@pytest.fixture(scope="module")
def mlm():
    """tests/test_albef.py:173's configuration with adapters (the ensemble
    mode runs them), initialised by JAX with encoder states of the hidden
    width (which flax infers; the port's config states it)."""
    adapter = dict(names=("adapter_0", "adapter_1", "adapter_2"), reduction_factor=4)
    jmodel = JaxMaskedLM(JaxBertConfig(**MLM_BERT), JaxAdapterSpec(**adapter))
    rng = np.random.RandomState(5)
    ids = rng.randint(1, 100, size=(2, 8)).astype(np.int32)
    mask = np.ones((2, 8), np.int32)
    mask[1, 6:] = 0
    enc = rng.randn(2, 5, 32).astype(np.float32)
    abstract = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), ids, mask,
                                                  encoder_hidden_states=enc,
                                                  adapter_mode="init_all"))["params"]
    params = random_like_init(abstract, 11)
    model = XBertMaskedLM(AlbefBertConfig(**MLM_BERT, encoder_width=32), AdapterSpec(**adapter))
    model.load_state_dict(xbert_mlm_from_flax(params), strict=True)
    labels = np.where(rng.rand(2, 8) < 0.4, ids, -100).astype(np.int32)
    labels[0, 0] = ids[0, 0]  # at least one position counts
    soft = rng.dirichlet(np.ones(100), size=(2, 8)).astype(np.float32)
    return jmodel, params, model.eval(), dict(ids=ids, mask=mask, enc=enc, labels=labels, soft=soft)


@pytest.mark.parametrize("case", ["logits", "logits_multimodal", "loss", "loss_soft"])
def test_masked_lm_matches_jax(mlm, case):
    jmodel, params, model, d = mlm
    kw = dict(adapter_mode="ensemble")
    if case != "logits":
        kw["encoder_hidden_states"] = d["enc"]
    if case.startswith("loss"):
        kw["labels"] = d["labels"]
    if case == "loss_soft":
        kw.update(soft_labels=d["soft"], alpha=0.4)
    want = jax.jit(lambda p, ids, mask, arrays: jmodel.apply(
        {"params": p}, ids, mask, **{**kw, **arrays}))(
        params, d["ids"], d["mask"], {k: v for k, v in kw.items() if isinstance(v, np.ndarray)})
    with torch.no_grad():
        got = model(torch.from_numpy(d["ids"]), torch.from_numpy(d["mask"]),
                    **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
    if case.startswith("logits"):
        assert got.shape == (2, 8, 100)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
        return
    (loss, logits), (jloss, jlogits) = got, want
    assert loss.dim() == 0 and np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["prompt", "freeze_encoder", "none", "freeze_bottom_k_layers"])
def test_plain_step_matches_jax(mode):
    check_plain_step(mode)
