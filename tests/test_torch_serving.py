"""The port's ViltVqaPredictor against the JAX one on the same weights (CPU,
float32): same preprocessing, same top-k answers, probabilities within
rtol=1e-4, atol=1e-5; and the bucket/padding invariance of
tests/test_serving.py."""

import dataclasses

import numpy as np
import pytest
from PIL import Image

from feddat_tpu.data.tokenizer import WordPieceTokenizer as JaxTokenizer
from feddat_tpu.serving import ViltVqaPredictor as JaxPredictor
from feddat_tpu_torch.data.tokenizer import WordPieceTokenizer
from feddat_tpu_torch.serving import ViltVqaPredictor, _bucket_for, _normalize_buckets

from conftest import TINY_VILT
from test_torch_vilt import jax_model_and_params, port_model

WORDS = ["what", "is", "the", "color"]
LABELS = [f"ans{i}" for i in range(16)]
HEADS = {"t": dict(num_labels=16)}


def _images(n, seed, hw=(40, 56)):
    rng = np.random.RandomState(seed)
    return [Image.fromarray(rng.randint(0, 255, (*hw, 3), dtype=np.uint8)) for _ in range(n)]


@pytest.fixture(scope="module")
def weights():
    return jax_model_and_params(TINY_VILT, heads=HEADS)


def _port(params, cfg=TINY_VILT, attn_impl="auto", **kw):
    return ViltVqaPredictor(
        port_model(cfg, params, attn_impl, HEADS), None, "t", WordPieceTokenizer.toy(WORDS),
        LABELS, canvas=cfg.image_size, max_text_len=cfg.max_text_len, device="cpu", **kw,
    )


@pytest.mark.parametrize("attn_impl", ["auto", "block"])
def test_predictions_match_jax_predictor(weights, attn_impl):
    jmodel, params = weights
    cfg = dataclasses.replace(TINY_VILT, fuse_ln=attn_impl == "block")
    imgs = _images(5, 0)
    qs = [f"what is the color {i}" for i in range(5)]
    jax_pred = JaxPredictor(jmodel, params, "t", JaxTokenizer.toy(WORDS), LABELS,
                            batch_size=4, canvas=cfg.image_size, max_text_len=cfg.max_text_len)
    port_pred = _port(params, cfg, attn_impl, batch_size=4)
    np.testing.assert_array_equal(
        port_pred._preprocess(imgs, qs)["pixel_values"], jax_pred._preprocess(imgs, qs)["pixel_values"]
    )
    want = jax_pred.predict(imgs, qs, top_k=3)
    got = port_pred.predict(imgs, qs, top_k=3)
    assert len(got) == 5 and all(len(r) == 3 for r in got)
    for rg, rw in zip(got, want):
        assert [a for a, _ in rg] == [a for a, _ in rw]
        np.testing.assert_allclose([p for _, p in rg], [p for _, p in rw], rtol=1e-4, atol=1e-5)


def test_batch_buckets_and_padding_invariance(weights):
    assert _normalize_buckets((1, 4), 8) == (1, 4, 8)
    assert _normalize_buckets(None, 8) == (8,)
    assert [_bucket_for(n, (1, 4, 8)) for n in (1, 3, 8)] == [1, 4, 8]
    with pytest.raises(ValueError):
        _normalize_buckets((0,), 8)
    _, params = weights
    imgs = _images(5, 1)
    qs = [f"what is the color {i}" for i in range(5)]
    full = _port(params, batch_size=8).predict(imgs, qs, top_k=3)
    for row in full:
        probs = [p for _, p in row]
        assert probs == sorted(probs, reverse=True)
    for other in (_port(params, batch_size=4).predict(imgs, qs, top_k=3),
                  _port(params, batch_size=8, batch_buckets=(1, 2)).predict(imgs, qs, top_k=3)):
        for rf, ro in zip(full, other):
            assert [a for a, _ in rf] == [a for a, _ in ro]
            np.testing.assert_allclose([p for _, p in rf], [p for _, p in ro], rtol=1e-5, atol=1e-6)
    one = _port(params, batch_size=8, batch_buckets=(1,)).predict(imgs[:1], qs[:1], top_k=2)
    assert [a for a, _ in one[0]] == [a for a, _ in full[0][:2]]


def test_predictor_takes_a_jax_param_tree(weights):
    """params_or_state may be the JAX tree itself; it goes through the bridge."""
    jmodel, params = weights
    from feddat_tpu_torch.models.vilt import TaskHeadSpec, ViltContinualLearner
    from test_torch_vilt import port_config

    fresh = ViltContinualLearner(port_config(TINY_VILT), {"t": TaskHeadSpec(16)})
    pred = ViltVqaPredictor(fresh, params, "t", WordPieceTokenizer.toy(WORDS), LABELS,
                            batch_size=4, canvas=TINY_VILT.image_size,
                            max_text_len=TINY_VILT.max_text_len, device="cpu")
    imgs, qs = _images(2, 2), ["what is", "the color"]
    got = pred.predict(imgs, qs, top_k=2)
    want = _port(params, batch_size=4).predict(imgs, qs, top_k=2)
    assert got == want
    with pytest.raises(ValueError):
        pred.predict(imgs, qs[:1])
