"""The port's ALBEF serving path against the JAX package on the same weights
(CPU, tiny widths): the parameter bridge, the ViT tokens, ``encode_question``,
``decode_logits`` unpacked and packed, ``rank_answer`` for ``attn_impl``
"auto" and "flash" (JAX runs the Pallas flash kernel in interpret mode, the
port its plain version), packed (k=16) and unpacked (k=12), on a bank whose
answers share first tokens; ``AlbefVqaPredictor`` against the JAX predictor;
and the rank-answer eval step.

Tolerance: fp32 rtol=1e-4, atol=1e-5, as in tests/test_pallas_kernels.py —
both sides compute the same fp32 function and differ only in summation
order.  Answer ids must be equal, tie order included."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from feddat_tpu.configs.core import AdapterSpec as JaxAdapterSpec
from feddat_tpu.configs.core import AlbefBertConfig as JaxBertConfig
from feddat_tpu.configs.core import AlbefModelConfig as JaxAlbefConfig
from feddat_tpu.data.tokenizer import WordPieceTokenizer as JaxTokenizer
from feddat_tpu.models.albef import AlbefModel as JaxAlbef
from feddat_tpu.models.albef import init_albef_params as jax_init_albef_params
from feddat_tpu.models.albef import shifted_lm_loss as jax_shifted_lm_loss
from feddat_tpu.serving import AlbefVqaPredictor as JaxPredictor
from feddat_tpu.train.evaluation import make_albef_eval_step as jax_make_albef_eval_step
from feddat_tpu_torch.configs.core import (
    AdapterSpec,
    AlbefBertConfig,
    AlbefModelConfig,
    LoraSpec,
    PromptSpec,
)
from feddat_tpu_torch.data.tokenizer import WordPieceTokenizer
from feddat_tpu_torch.models.albef import AlbefModel, init_albef_params, shifted_lm_loss
from feddat_tpu_torch.serving import AlbefVqaPredictor
from feddat_tpu_torch.train.evaluation import make_albef_eval_step
from feddat_tpu_torch.utils.param_bridge import albef_from_flax

RTOL, ATOL = 1e-4, 1e-5
TINY = JaxAlbefConfig(
    image_res=32, patch_size=16, vision_width=32, vision_layers=2, vision_heads=4,
    bert=JaxBertConfig(vocab_size=96, hidden_size=32, num_layers=4, num_heads=4,
                       intermediate_size=64, max_position_embeddings=16, hidden_dropout=0.0,
                       attention_dropout=0.0, fusion_layer=2, encoder_width=32),
    decoder_layers=2, max_question_len=8, max_answer_len=4,
    adapter=JaxAdapterSpec(names=("adapter_0", "adapter_1", "adapter_2"), reduction_factor=4),
)
LQ, LA = TINY.max_question_len, TINY.max_answer_len
WORDS = ["what", "is", "the", "color", "of", "red", "blue", "car", "hat", "dog", "yes", "no"]
# 20 answers over 6 first words: stage 1 ties within each group of a first word
ANSWERS = ["red", "red car", "red hat", "red dog", "blue", "blue car", "blue hat", "yes",
           "yes red", "yes blue", "no", "no car", "no hat", "dog", "dog car", "dog red",
           "hat", "hat red", "hat blue", "red red"]


def port_config(jax_cfg) -> AlbefModelConfig:
    d = dataclasses.asdict(jax_cfg)
    d["bert"] = AlbefBertConfig(**d["bert"])
    d["adapter"] = AdapterSpec(**d["adapter"])
    d["lora"] = LoraSpec(**d["lora"])
    d["prompt"] = PromptSpec(**d["prompt"])
    return AlbefModelConfig(**d)


def _batch(rng, b, u8=True):
    ids = rng.randint(5, 60, (b, LQ)).astype(np.int32)
    mask = np.ones((b, LQ), np.int32)
    mask[0, LQ - 3:] = 0
    ids[mask == 0] = 0
    pix = (rng.randint(0, 256, (b, 32, 32, 3)).astype(np.uint8) if u8
           else rng.randn(b, 32, 32, 3).astype(np.float32))
    return {"pixel_values": pix, "question_ids": ids, "question_mask": mask}


def _bank():
    return JaxTokenizer.toy(WORDS).batch_encode(ANSWERS, LA)


@pytest.fixture(scope="module")
def weights():
    """JAX-initialised ALBEF params (numpy leaves)."""
    rng = np.random.RandomState(0)
    batch = _batch(rng, 2, u8=False)
    ans = rng.randint(5, 60, (2, 3, LA)).astype(np.int32)
    batch.update(answer_ids=ans, answer_mask=np.ones_like(ans),
                 answer_weights=np.ones((2, 3), np.float32))
    params = jax_init_albef_params(JaxAlbef(TINY), jax.random.PRNGKey(0), batch)
    return jax.tree_util.tree_map(np.asarray, params)


def port_model(params, attn_impl="auto", cfg=TINY):
    model = AlbefModel(port_config(cfg), attn_impl=attn_impl)
    model.load_state_dict(albef_from_flax(params), strict=True)
    return model.eval()


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def test_param_bridge_uses_every_leaf_once(weights):
    sd = albef_from_flax(weights)
    leaves = jax.tree_util.tree_leaves_with_path(weights)
    stacks = ("blocks", "text_layers", "fusion_layers")
    n_expected = sum(leaf.shape[0] if any(s in jax.tree_util.keystr(p) for s in stacks) else 1
                     for p, leaf in leaves)
    model = port_model(weights)
    assert len(sd) == n_expected == len(model.state_dict())
    assert set(sd) == set(model.state_dict())
    dec = weights["text_decoder"]["bert"]["encoder"]["fusion_layers"]["layer"]
    np.testing.assert_array_equal(
        sd["text_decoder.bert.encoder.fusion_layers.1.crossattention.key.weight"].numpy(),
        dec["crossattention"]["key"]["kernel"][1].T)
    np.testing.assert_array_equal(
        sd["visual_encoder.patch_embed.weight"].numpy(),
        weights["visual_encoder"]["patch_embed"]["kernel"].transpose(3, 2, 0, 1))
    # the vocabulary projection is the decoder's word-embedding tensor itself
    head = model.text_decoder
    hidden = torch.randn(2, 3, 32)
    with torch.no_grad():
        before = head.cls_logits(hidden)
        head.bert.embeddings.word_embeddings.weight[7] += 1.0
        after = head.cls_logits(hidden)
    changed = (before != after).any(dim=(0, 1))
    assert changed[7] and changed.sum() == 1
    assert "text_decoder.cls.decoder.bias" in sd and not any(
        k.startswith("text_decoder.cls.decoder.") and k.endswith("weight") for k in sd)


def _jax_apply(method, *args, attn_impl="auto", params=None, cfg=TINY, **kw):
    """``model.apply(..., method=method)`` under jit; arrays (and dicts of
    them) are traced, every other argument is static."""
    model = JaxAlbef(cfg, attn_impl=attn_impl)
    traced = [isinstance(a, (np.ndarray, dict)) for a in args]

    def call(p, arrays):
        it = iter(arrays)
        full = [next(it) if t else a for a, t in zip(args, traced)]
        return model.apply({"params": p}, *full, method=method, **kw)

    return jax.jit(call)(params, [a for a, t in zip(args, traced) if t])


def test_vit_tokens_and_question_states_match_jax(weights):
    """The ViT on raw u8 pixels and encode_question, DAT ensemble mode."""
    batch = _batch(np.random.RandomState(1), 3)
    tmodel = port_model(weights)
    jv = _jax_apply(lambda m, px: m.visual_encoder(px, adapter_mode="ensemble"),
                    batch["pixel_values"], params=weights)
    jq = _jax_apply(JaxAlbef.encode_question, batch["pixel_values"], batch["question_ids"],
                    batch["question_mask"], "ensemble", params=weights)
    t = to_torch(batch)
    with torch.no_grad():
        tv = tmodel.visual_encoder(t["pixel_values"], "ensemble")
        tq = tmodel.encode_question(t["pixel_values"], t["question_ids"], t["question_mask"],
                                    "ensemble")
    assert tv.shape == (3, 5, 32) and tq.shape == (3, LQ, 32)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("pack_group", [1, 2])
def test_decode_logits_match_jax(weights, pack_group):
    """The decoder over k=4 candidate rows per question, grouped in the
    cross-attention, unpacked and packed two per self-attention row."""
    rng = np.random.RandomState(2)
    b, k = 2, 4
    states = rng.randn(b, LQ, 32).astype(np.float32)
    qmask = np.ones((b, LQ), np.int32)
    qmask[1, 5:] = 0
    ids, mask = _bank()
    ids, mask = ids[:b * k], mask[:b * k]
    want = _jax_apply(JaxAlbef.decode_logits, ids, mask, states, qmask, "adapter_0",
                      params=weights, cross_group=k, pack_group=pack_group)
    with torch.no_grad():
        got = port_model(weights).decode_logits(
            *(torch.from_numpy(a) for a in (ids, mask, states, qmask)), "adapter_0",
            cross_group=k, pack_group=pack_group)
    assert got.shape == (b * k, LA, 96)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    targets = np.where(ids == 0, -100, ids)
    soft = rng.dirichlet(np.ones(96), size=(b * k, LA - 1)).astype(np.float32)
    for extra in ((), (soft, 0.4)):  # the CE, and its mix with soft labels
        np.testing.assert_allclose(
            shifted_lm_loss(got, torch.from_numpy(targets), *(torch.as_tensor(e) for e in extra)).numpy(),
            np.asarray(jax_shifted_lm_loss(want, jnp.asarray(targets), *extra)), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("attn_impl", ["auto", "flash"])
@pytest.mark.parametrize("k", [16, 12])
def test_rank_answer_matches_jax(weights, attn_impl, k):
    """k=16 packs the rerank decode 8 per row (eval_pack_group), k=12 does not.
    First tokens repeat across the bank, so stage 1 has exact ties: the
    candidate set and order follow jax.lax.top_k's lower-index-first rule."""
    batch = _batch(np.random.RandomState(3), 3)
    ids, mask = _bank()
    want_ids, want_p = _jax_apply(JaxAlbef.rank_answer, batch, ids, mask, k, "ensemble",
                                  attn_impl=attn_impl, params=weights)
    with torch.no_grad():
        got_ids, got_p = port_model(weights, attn_impl).rank_answer(
            to_torch(batch), torch.from_numpy(ids), torch.from_numpy(mask), k, "ensemble")
    assert got_ids.shape == (3, k)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=RTOL, atol=ATOL)


def _images(n, seed):
    rng = np.random.RandomState(seed)
    sizes = [(40, 56), (33, 30), (64, 48)]
    return [Image.fromarray(rng.randint(0, 255, (*sizes[i % 3], 3), dtype=np.uint8))
            for i in range(n)]


QUESTIONS = ["What is the color of the car?", "is the dog red", "What-is the hat/color",
             "is it blue?", "the color of the dog"]


def _port_pred(weights, **kw):
    return AlbefVqaPredictor(port_model(weights), None, WordPieceTokenizer.toy(WORDS), ANSWERS,
                             k=8, max_question_len=LQ, max_answer_len=LA, device="cpu", **kw)


def test_predictor_matches_jax_predictor(weights):
    imgs = _images(5, 0)
    jax_pred = JaxPredictor(JaxAlbef(TINY), weights, JaxTokenizer.toy(WORDS), ANSWERS, batch_size=4,
                            k=8, max_question_len=LQ, max_answer_len=LA)
    port_pred = _port_pred(weights, batch_size=4)
    jb, tb = jax_pred._preprocess(imgs, QUESTIONS), port_pred._preprocess(imgs, QUESTIONS)
    assert set(jb) == set(tb)
    for key in jb:
        np.testing.assert_array_equal(tb[key], jb[key])
    want = jax_pred.predict(imgs, QUESTIONS, top_k=3)
    got = port_pred.predict(imgs, QUESTIONS, top_k=3)
    assert len(got) == 5 and all(len(r) == 3 for r in got)
    for rg, rw in zip(got, want):
        assert [a for a, _ in rg] == [a for a, _ in rw]
        np.testing.assert_allclose([p for _, p in rg], [p for _, p in rw], rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="rerank width"):
        port_pred.predict(imgs, QUESTIONS, top_k=9)
    with pytest.raises(ValueError):
        port_pred.predict(imgs, QUESTIONS[:2])
    with pytest.raises(FileNotFoundError, match="no meta.json"):
        AlbefVqaPredictor.from_checkpoint("no-such-checkpoint-dir", WordPieceTokenizer.toy(WORDS),
                                          device="cpu")


def test_predictor_buckets_and_padding_invariance(weights):
    imgs = _images(5, 1)
    full = _port_pred(weights, batch_size=8).predict(imgs, QUESTIONS, top_k=4)
    for row in full:
        probs = [p for _, p in row]
        assert probs == sorted(probs, reverse=True)
    other = _port_pred(weights, batch_size=2, batch_buckets=(1,)).predict(imgs, QUESTIONS, top_k=4)
    for rf, ro in zip(full, other):
        assert [a for a, _ in rf] == [a for a, _ in ro]
        np.testing.assert_allclose([p for _, p in rf], [p for _, p in ro], rtol=1e-5, atol=1e-6)
    big = _port_pred(weights, batch_size=4)
    assert big.k == 8 and _port_pred(weights, batch_size=4).bank[0].shape == (len(ANSWERS), LA)
    capped = AlbefVqaPredictor(port_model(weights), weights, WordPieceTokenizer.toy(WORDS),
                               ANSWERS[:5], k=64, max_question_len=LQ, max_answer_len=LA,
                               device="cpu")
    assert capped.k == 5  # k is capped by the bank; a JAX param tree loads through the bridge
    assert len(capped.predict(imgs[:1], QUESTIONS[:1], top_k=5)[0]) == 5


def test_albef_eval_step_matches_jax(weights):
    batch = _batch(np.random.RandomState(4), 4)
    ids, mask = _bank()
    jstep = jax_make_albef_eval_step(JaxAlbef(TINY), ids, mask, k=12)
    tmodel = port_model(weights)
    tstep = make_albef_eval_step(tmodel, ids, mask, k=12)
    pred = np.asarray(jax.jit(lambda p, b: JaxAlbef(TINY).apply(
        {"params": p}, b, jnp.asarray(ids), jnp.asarray(mask), 12, "ensemble",
        method=JaxAlbef.rank_answer))(weights, batch)[0])[:, 0]
    # ground truth: hit for rows 0 and 2 (row 3 masked out by `valid`)
    gt = np.full((4, 3), -1, np.int32)
    gt[0, 1], gt[2, 0], gt[3, 2], gt[1, 0] = pred[0], pred[2], pred[3], (pred[1] + 1) % len(ANSWERS)
    batch.update(gt_labels=gt, valid=np.array([1, 1, 1, 0], np.float32))
    want = float(jstep(weights, batch, "ensemble"))
    params = {k: v.detach() for k, v in tmodel.state_dict().items()}
    got = float(tstep(params, batch, "ensemble"))
    assert want == got == 2.0


def test_seeded_init_follows_jax_scheme():
    cfg = port_config(TINY)

    def make(seed):
        return init_albef_params(AlbefModel(cfg), seed).state_dict()

    sd, again, other = make(7), make(7), make(8)
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    assert not torch.equal(sd["visual_encoder.patch_embed.weight"],
                           other["visual_encoder.patch_embed.weight"])
    for zero in ("visual_encoder.pos_embed", "visual_encoder.cls_token", "text_decoder.cls.decoder.bias",
                 "text_encoder.encoder.fusion_layers.0.crossattention.key.bias"):
        assert torch.all(sd[zero] == 0), zero
    assert torch.all(sd["text_encoder.encoder.text_layers.1.output_norm.weight"] == 1)
    std = sd["text_decoder.bert.embeddings.word_embeddings.weight"].std().item()
    assert abs(std - 0.02) < 3e-3


@pytest.mark.parametrize("attn_impl,routes", [
    ("flash", {"attn_impl": "flash"}),
    ("auto", {"attn_impl": "auto"}),
    ("block", {"attn_impl": "auto", "vision_attn_impl": "block"}),
    ("layer", {"attn_impl": "auto", "vision_attn_impl": "layer"}),
])
def test_create_model_routes_albef_like_jax(attn_impl, routes, monkeypatch):
    """create_model's ALBEF branch (models/__init__.py:101-126 in JAX): 'block'
    and 'layer' route the ViT alone, every other value every site; the remat
    arguments reach the config as JAX's do (the tuned configuration's
    ``remat``, ``block_save_nox`` and ``names``).  The model class is replaced
    by a recorder so no full-width model is built."""
    from feddat_tpu_torch.configs.core import PEFTMode
    from feddat_tpu_torch.models import albef, create_model

    seen = {}

    class Recorder(torch.nn.Module):
        def __init__(self, cfg, dtype, **kw):
            super().__init__()
            seen.update(cfg=cfg, dtype=dtype, **kw)

    monkeypatch.setattr(albef, "AlbefModel", Recorder)
    monkeypatch.setattr(albef, "init_albef_params", lambda m, seed: m)
    _, cfg = create_model("albef_no_distill", {}, PEFTMode.DAT, dtype="bfloat16",
                          attn_impl=attn_impl, remat=True, remat_policy="block_save_nox",
                          text_remat_policy="names", attention_logits_dtype="bfloat16",
                          device="cpu")
    assert {k: v for k, v in seen.items() if k not in ("cfg", "dtype")} == routes
    assert seen["dtype"] == torch.bfloat16 and seen["cfg"] is cfg
    assert cfg.adapter.names == ("adapter_0", "adapter_1", "adapter_2") and not cfg.distill
    assert cfg.fuse_ln and cfg.eval_pack_group == 8 and cfg.image_res == 384
    assert (cfg.remat, cfg.remat_policy, cfg.text_remat, cfg.text_remat_policy) == (
        True, "block_save_nox", None, "names")
    assert cfg.attention_logits_dtype == "bfloat16"
    from feddat_tpu.configs.core import PEFTMode as JaxPEFTMode
    from feddat_tpu.models import create_model as jax_create_model

    _, jcfg = jax_create_model("albef_no_distill", {}, JaxPEFTMode.DAT, dtype="bfloat16",
                               attn_impl=attn_impl, remat=True, remat_policy="block_save_nox",
                               text_remat_policy="names", attention_logits_dtype="bfloat16")
    for field in ("remat", "remat_policy", "text_remat", "text_remat_policy", "fuse_ln",
                  "attention_logits_dtype"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    _, plain = create_model("albef_no_distill", {}, PEFTMode.DAT, attn_impl=attn_impl, device="cpu")
    assert (plain.remat, plain.remat_policy, plain.text_remat_policy) == (False, "full", "full")
