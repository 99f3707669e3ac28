"""The port's pretrained-checkpoint converter (``utils/checkpoint_convert.py``)
against the JAX package's on the CPU.  The state dicts are built here with
the published key names at tiny widths (HF ViLT, HF BERT with and without
cross-attention and its LM head, timm ViT, ALBEF's ``.pth``); no weights
file is read.

Exact: the port's converted tree equals the JAX package's leaf for leaf and
bit for bit, carried through ``utils/param_bridge.py`` it loads into the
port's models, and ``merge_pretrained`` on the port's state_dict equals the
JAX merge carried through the bridge.  ``interpolate_pos_embed`` is bitwise
JAX's at square and non-square targets (tests/test_albef_checkpoint.py)."""

import jax
import numpy as np
import pytest
import torch

from feddat_tpu.utils import checkpoint_convert as jcc
from feddat_tpu_torch.models.albef import AlbefModel
from feddat_tpu_torch.utils import checkpoint_convert as cc
from feddat_tpu_torch.utils.param_bridge import albef_from_flax, vilt_from_flax

from conftest import TINY_VILT
from feddat_tpu.configs.core import AdapterSpec as JaxAdapterSpec
from feddat_tpu.configs.core import AlbefBertConfig as JaxBertConfig
from feddat_tpu.configs.core import AlbefModelConfig as JaxAlbefConfig
from test_albef_checkpoint import FUSION, IMG, L_DEC, L_TEXT, PATCH, _fake_albef_state_dict
from test_albef_checkpoint import HEADS as ALBEF_HEADS
from test_albef_checkpoint import INTER as ALBEF_INTER
from test_albef_checkpoint import VOCAB as ALBEF_VOCAB
from test_torch_albef import port_config as albef_port_config
from test_torch_vilt import jax_model_and_params, port_model

H, INTER, VOCAB = TINY_VILT.hidden_size, TINY_VILT.intermediate_size, TINY_VILT.vocab_size
HEADS = {"t": dict(num_labels=16)}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _assert_trees_equal(got, want):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg="/".join(k))


def _hf_vilt_state_dict(rng, grid=3, layers=2, half=False, h=H, inter=INTER, vocab=VOCAB,
                        text_len=TINY_VILT.max_text_len, p=TINY_VILT.patch_size):
    """HF ``ViltModel.state_dict()`` names at TINY_VILT's widths (or the
    ones given), a square ``grid`` of checkpoint patches and a 2-row modality
    table."""
    def t(*shape):
        x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        return x.to(torch.bfloat16) if half else x

    te = "embeddings.text_embeddings"
    sd = {f"{te}.word_embeddings.weight": t(vocab, h), f"{te}.position_embeddings.weight": t(text_len, h),
          f"{te}.token_type_embeddings.weight": t(2, h), f"{te}.LayerNorm.weight": t(h),
          f"{te}.LayerNorm.bias": t(h), "embeddings.cls_token": t(1, 1, h),
          "embeddings.position_embeddings": t(1, grid * grid + 1, h),
          "embeddings.patch_embeddings.projection.weight": t(h, 3, p, p),
          "embeddings.patch_embeddings.projection.bias": t(h),
          "embeddings.token_type_embeddings.weight": t(2, h),
          "layernorm.weight": t(h), "layernorm.bias": t(h),
          "pooler.dense.weight": t(h, h), "pooler.dense.bias": t(h)}
    for i in range(layers):
        b = f"encoder.layer.{i}"
        for ln in ("layernorm_before", "layernorm_after"):
            sd[f"{b}.{ln}.weight"], sd[f"{b}.{ln}.bias"] = t(h), t(h)
        for part in ("query", "key", "value"):
            sd[f"{b}.attention.attention.{part}.weight"] = t(h, h)
            sd[f"{b}.attention.attention.{part}.bias"] = t(h)
        sd[f"{b}.attention.output.dense.weight"], sd[f"{b}.attention.output.dense.bias"] = t(h, h), t(h)
        sd[f"{b}.intermediate.dense.weight"], sd[f"{b}.intermediate.dense.bias"] = t(inter, h), t(inter)
        sd[f"{b}.output.dense.weight"], sd[f"{b}.output.dense.bias"] = t(h, inter), t(h)
    return sd


@pytest.mark.parametrize("half", [False, True])
def test_hf_vilt_converts_as_jax_and_loads_into_the_port(half):
    sd = _hf_vilt_state_dict(np.random.RandomState(0), half=half)
    grid = (TINY_VILT.image_size[0] // 16, TINY_VILT.image_size[1] // 16)
    got = cc.convert_hf_vilt(sd, num_layers=2, num_patches_new=grid)
    _assert_trees_equal(got, jcc.convert_hf_vilt(sd, num_layers=2, num_patches_new=grid))
    assert got["modality_type_embeddings"]["embedding"].shape == (3, H)
    _, params = jax_model_and_params(TINY_VILT, heads=HEADS)
    model = port_model(TINY_VILT, params, "auto", HEADS)
    merged = cc.merge_pretrained(model.state_dict(), {"vilt": got}, strict=True)
    want = vilt_from_flax(jax.tree_util.tree_map(np.asarray,
                                                 jcc.merge_pretrained(params, {"vilt": got})))
    assert merged.keys() == want.keys()
    for k in want:
        assert torch.equal(merged[k], want[k]), k
    model.load_state_dict(merged, strict=True)
    assert torch.equal(model.state_dict()["vilt.pooler.weight"], sd["pooler.dense.weight"].float())
    adapter = "vilt.layers.0.adapter.adapter_0_up.bias"
    assert torch.equal(merged[adapter], vilt_from_flax(params)[adapter])  # fresh init kept


def test_merge_pretrained_refuses_mismatches():
    state = {"a.weight": torch.zeros(2, 3), "b.bias": torch.zeros(3, dtype=torch.bfloat16)}
    out = cc.merge_pretrained(state, {"a.weight": np.ones((2, 3), np.float64), "extra": np.ones(1)})
    assert out["a.weight"].dtype == torch.float32 and out["a.weight"].sum() == 6
    assert out["b.bias"] is state["b.bias"]
    with pytest.raises(KeyError, match="extra"):
        cc.merge_pretrained(state, {"extra": np.ones(1)}, strict=True)
    with pytest.raises(ValueError, match="shape mismatch"):
        cc.merge_pretrained(state, {"a.weight": np.ones((3, 2))})


def _bert_state_dict(rng, layers, cross_from, prefix=""):
    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    e = f"{prefix}embeddings"
    sd = {f"{e}.word_embeddings.weight": t(VOCAB, H), f"{e}.position_embeddings.weight": t(16, H),
          f"{e}.token_type_embeddings.weight": t(2, H), f"{e}.LayerNorm.weight": t(H),
          f"{e}.LayerNorm.bias": t(H)}
    for i in range(layers):
        b = f"{prefix}encoder.layer.{i}"
        kinds = ("attention", "crossattention") if i >= cross_from else ("attention",)
        for kind in kinds:
            for part in ("query", "key", "value"):
                sd[f"{b}.{kind}.self.{part}.weight"], sd[f"{b}.{kind}.self.{part}.bias"] = t(H, H), t(H)
            sd[f"{b}.{kind}.output.dense.weight"], sd[f"{b}.{kind}.output.dense.bias"] = t(H, H), t(H)
            sd[f"{b}.{kind}.output.LayerNorm.weight"] = t(H)
            sd[f"{b}.{kind}.output.LayerNorm.bias"] = t(H)
        sd[f"{b}.intermediate.dense.weight"], sd[f"{b}.intermediate.dense.bias"] = t(INTER, H), t(INTER)
        sd[f"{b}.output.dense.weight"], sd[f"{b}.output.dense.bias"] = t(H, INTER), t(H)
        sd[f"{b}.output.LayerNorm.weight"], sd[f"{b}.output.LayerNorm.bias"] = t(H), t(H)
    c = "cls.predictions"
    sd.update({f"{c}.transform.dense.weight": t(H, H), f"{c}.transform.dense.bias": t(H),
               f"{c}.transform.LayerNorm.weight": t(H), f"{c}.transform.LayerNorm.bias": t(H),
               f"{c}.decoder.weight": t(VOCAB, H), f"{c}.decoder.bias": t(VOCAB)})
    return sd


@pytest.mark.parametrize("cross_from", [2, 99])  # ALBEF's trained cross weights; plain BERT
def test_bert_to_xbert_and_lm_head_convert_as_jax(cross_from):
    sd = _bert_state_dict(np.random.RandomState(1), 4, cross_from, prefix="bert.")
    got = cc.convert_bert_to_xbert(sd, num_layers=4, fusion_layer=2, prefix="bert.")
    _assert_trees_equal(got, jcc.convert_bert_to_xbert(sd, num_layers=4, fusion_layer=2,
                                                       prefix="bert."))
    fusion = got["encoder"]["fusion_layers"]["layer"]
    if cross_from > 4:  # the cross weights start as the layer's self-attention
        np.testing.assert_array_equal(fusion["crossattention"]["key"]["kernel"],
                                      fusion["attention"]["key"]["kernel"])
    _assert_trees_equal(cc.convert_bert_lm_head(sd), jcc.convert_bert_lm_head(sd))
    sd.pop("cls.predictions.decoder.bias")
    sd["cls.predictions.bias"] = torch.ones(VOCAB)
    _assert_trees_equal(cc.convert_bert_lm_head(sd), jcc.convert_bert_lm_head(sd))


def test_timm_vit_and_albef_convert_as_jax_and_load_into_the_port():
    sd = _fake_albef_state_dict(np.random.RandomState(0))
    vit = {k[len("visual_encoder."):]: v for k, v in sd.items() if k.startswith("visual_encoder.")}
    _assert_trees_equal(cc.convert_vit_timm(vit, num_layers=2, num_patches_new=4),
                        jcc.convert_vit_timm(vit, num_layers=2, num_patches_new=4))
    kw = dict(num_patches_new=4, fusion_layer=FUSION, num_text_layers=L_TEXT,
              decoder_layers=L_DEC, vision_layers=2)
    got = cc.convert_albef_checkpoint(sd, **kw)
    _assert_trees_equal(got, jcc.convert_albef_checkpoint(sd, **kw))
    # the published checkpoint's "module." prefix is stripped the same way
    prefixed = {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}
    _assert_trees_equal(cc.convert_albef_checkpoint(prefixed, **kw), got)
    bert = JaxBertConfig(vocab_size=ALBEF_VOCAB, hidden_size=H, num_layers=L_TEXT,
                         num_heads=ALBEF_HEADS, intermediate_size=ALBEF_INTER,
                         max_position_embeddings=16, hidden_dropout=0.0, attention_dropout=0.0,
                         fusion_layer=FUSION, encoder_width=H)
    cfg = JaxAlbefConfig(image_res=IMG, patch_size=PATCH, vision_width=H, vision_layers=2,
                         vision_heads=ALBEF_HEADS, bert=bert, decoder_layers=L_DEC,
                         adapter=JaxAdapterSpec(names=("adapter_0", "adapter_1", "adapter_2"),
                                                reduction_factor=4))
    model = AlbefModel(albef_port_config(cfg))  # tests/test_albef_checkpoint.py's model
    state = model.state_dict()
    pretrained = albef_from_flax(got)
    assert set(pretrained) <= set(state)
    merged = cc.merge_pretrained(state, got, strict=True, bridge=albef_from_flax)
    model.load_state_dict(merged, strict=True)
    word = "text_encoder.embeddings.word_embeddings.weight"
    assert torch.equal(model.state_dict()[word],
                       torch.from_numpy(sd["text_encoder.bert.embeddings.word_embeddings.weight"]))
    assert torch.equal(merged["text_decoder.cls.decoder.bias"],
                       torch.from_numpy(sd["text_encoder.cls.predictions.bias"]))


@pytest.mark.parametrize("target", [16, 64, 4, (12, 20), (2, 3)])
def test_interpolate_pos_embed_matches_jax(target):
    rng = np.random.RandomState(2)
    pos = rng.randn(1, 17, 8).astype(np.float32)
    got, want = cc.interpolate_pos_embed(pos, target), jcc.interpolate_pos_embed(pos, target)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 0], pos[:, 0])  # the CLS slot is kept
    already = rng.randn(1, 1 + 240, 8).astype(np.float32)
    np.testing.assert_array_equal(cc.interpolate_pos_embed(already, (12, 20)), already)
    with pytest.raises(AssertionError):
        cc.interpolate_pos_embed(pos, 240)  # a non-square int target
