"""The port's native host core (``feddat_tpu_torch/native``), built here with
``g++``, against the JAX package's (``feddat_tpu/native``) and against the
port's own numpy finalize and Python WordPiece: every output bitwise equal.
Both pipelines take it for the u8 cache when it is available and then give
the same batches as with the numpy finalize and as the JAX package's.  A
failed build leaves ``available()`` false and says why once."""

import logging

import numpy as np
import pytest

from feddat_tpu import native as jax_native
from feddat_tpu.data import datasets as jax_datasets
from feddat_tpu.data import images as jax_images
from feddat_tpu.data.albef_pipeline import AlbefVQAPipeline as JaxAlbefPipeline
from feddat_tpu.data.pipeline import ViltVQAPipeline as JaxViltPipeline
from feddat_tpu.data.tokenizer import WordPieceTokenizer as JaxTokenizer
from feddat_tpu_torch import native
from feddat_tpu_torch.data import datasets, images
from feddat_tpu_torch.data.albef_pipeline import AlbefVQAPipeline
from feddat_tpu_torch.data.pipeline import ViltVQAPipeline
from feddat_tpu_torch.data.tokenizer import WordPieceTokenizer
from feddat_tpu_torch.ops import _build

from test_torch_data import ANSWERS, WORDS, _assert_batches_equal, _examples, image_dir  # noqa: F401

REPO = _build._PKG.parent
VOCAB = REPO / "tests" / "fixtures" / "vocab30k.txt"
CANVAS = (64, 96)


def _u8_images(seed=0, n=7):
    """Variable sizes, some larger than the canvas (clipped), one 1x1."""
    rng = np.random.RandomState(seed)
    sizes = [(40, 30), (64, 96), (70, 100), (1, 1), (64, 20), (13, 96), (50, 51)][:n]
    return [rng.randint(0, 256, (h, w, 3), dtype=np.uint8) for h, w in sizes]


def test_the_library_builds_into_the_build_directory():
    assert native.available() and jax_native.available()
    path = native.library_path()
    assert path.parent == _build.BUILD_DIR and path.exists()
    assert not list(native.SOURCE.parent.glob("*.so"))


def test_finalize_canvas_batch_is_bitwise_jax_and_numpy():
    u8s = _u8_images()
    got, mask = native.finalize_canvas_batch(u8s, CANVAS, images.VILT_MEAN.tolist(),
                                             images.VILT_STD.tolist(), num_threads=3)
    want, want_mask = jax_native.finalize_canvas_batch(u8s, CANVAS, images.VILT_MEAN.tolist(),
                                                       images.VILT_STD.tolist(), num_threads=3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(mask, want_mask)
    ref = [images.finalize_vilt_u8(a, CANVAS) for a in u8s]
    np.testing.assert_array_equal(got, np.stack([p for p, _ in ref]))
    np.testing.assert_array_equal(mask, np.stack([m for _, m in ref]))
    # ALBEF's form: square images, CLIP statistics, no mask
    square = [np.random.RandomState(3).randint(0, 256, (32, 32, 3), dtype=np.uint8) for _ in range(3)]
    clip, none = native.finalize_canvas_batch(square, (32, 32), images.CLIP_MEAN.tolist(),
                                              images.CLIP_STD.tolist(), with_mask=False)
    assert none is None
    np.testing.assert_array_equal(
        clip, np.stack([(a.astype(np.float32) / 255.0 - images.CLIP_MEAN) / images.CLIP_STD
                        for a in square]))
    with pytest.raises(ValueError, match=r"\[h, w, 3\]"):
        native.finalize_canvas_batch([np.zeros((4, 4), np.uint8)], CANVAS, [0.5] * 3, [0.5] * 3)


def test_resize_normalize_batch_is_bitwise_jax():
    batch = np.random.RandomState(1).randint(0, 256, (3, 37, 53, 3), dtype=np.uint8)
    for out_hw in ((64, 96), (20, 11), (37, 53)):
        got = native.resize_normalize_batch(batch, out_hw, images.VILT_MEAN.tolist(),
                                            images.VILT_STD.tolist(), num_threads=2)
        want = jax_native.resize_normalize_batch(batch, out_hw, images.VILT_MEAN.tolist(),
                                                 images.VILT_STD.tolist(), num_threads=2)
        assert got.shape == (3, *out_hw, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


QUESTIONS = [
    "What color is the cat on the left?", "how many people are there in this picture",
    "Does this man have a hat?", "WHERE's the sign; what does it say?!", "", "   ",
    "unaffable antidisestablishmentarianism xyzzyqwv", "café crème brûlée?", "naïve résumé",
    "what is 2+2=4 (really)?", "a " * 60, "tab\tand\nnewline", "ümlaut and 中文 mixed",
]


@pytest.mark.parametrize("max_length", [8, 40])
def test_native_wordpiece_is_bitwise_jax_and_python(max_length):
    py = WordPieceTokenizer.from_vocab_file(str(VOCAB))
    tok = native.NativeWordPiece(py.vocab)
    jtok = jax_native.NativeWordPiece(JaxTokenizer.from_vocab_file(str(VOCAB)).vocab)
    ids, mask = tok.batch_encode(QUESTIONS, max_length, num_threads=3)
    want_ids, want_mask = jtok.batch_encode(QUESTIONS, max_length, num_threads=3)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(mask, want_mask)
    ref_ids, ref_mask = py.batch_encode(QUESTIONS, max_length)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_array_equal(mask, ref_mask)
    assert ids.dtype == mask.dtype == np.int32
    assert tok.encode(QUESTIONS[0]) == py.encode(QUESTIONS[0])
    assert tok.decode(ids[0]) == py.decode(ids[0])


@pytest.mark.parametrize("family", ["vilt", "albef"])
def test_pipelines_take_the_native_finalize_bitwise(image_dir, family):  # noqa: F811
    """With ``cache_images`` both pipelines finalize through the native core:
    the batches of two epochs are bitwise those of the numpy finalize and
    the JAX package's pipeline (which uses its own native core)."""
    if family == "vilt":
        common = dict(num_labels=len(ANSWERS), max_text_len=10, canvas=CANVAS, batch_size=4,
                      val_batch_size=3, seed=2, num_workers=2, cache_images=True)
        make = lambda: ViltVQAPipeline(_examples(datasets), images.VizwizBackend(image_dir),  # noqa: E731
                                       WordPieceTokenizer.toy(WORDS),
                                       eval_examples=_examples(datasets, 7, 1), **common)
        jax = JaxViltPipeline(_examples(jax_datasets), jax_images.VizwizBackend(image_dir),
                              JaxTokenizer.toy(WORDS), eval_examples=_examples(jax_datasets, 7, 1),
                              **common)
    else:
        common = dict(image_size=32, max_question_len=8, max_answer_len=4, max_answers_per_q=3,
                      gt_pad=4, batch_size=4, val_batch_size=3, seed=1, num_workers=2,
                      cache_images=True)
        make = lambda: AlbefVQAPipeline(_examples(datasets), images.VizwizBackend(image_dir),  # noqa: E731
                                        WordPieceTokenizer.toy(WORDS), ANSWERS,
                                        eval_examples=_examples(datasets, 7, 1), **common)
        jax = JaxAlbefPipeline(_examples(jax_datasets), jax_images.VizwizBackend(image_dir),
                               JaxTokenizer.toy(WORDS), ANSWERS,
                               eval_examples=_examples(jax_datasets, 7, 1), **common)
    port, numpy_path = make(), make()
    assert port._native_finalize is native.finalize_canvas_batch
    assert jax._native_finalize is not None
    numpy_path._native_finalize = None
    for epoch in (0, 1):
        batches = list(port.train_batches(epoch))
        _assert_batches_equal(batches, numpy_path.train_batches(epoch))
        _assert_batches_equal(batches, jax.train_batches(epoch))
    _assert_batches_equal(port.eval_batches(), jax.eval_batches())


def test_a_failed_build_leaves_it_unavailable_and_says_why_once(tmp_path, monkeypatch, caplog):
    bad = tmp_path / "feddat_native.cpp"
    bad.write_text('extern "C" int broken( { return 0; }\n')
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with caplog.at_level(logging.WARNING, logger="feddat_tpu_torch.native"):
        assert not native.available()
        assert not native.available()
    warnings = [r for r in caplog.records if "native host core unavailable" in r.getMessage()]
    assert len(warnings) == 1 and "error" in warnings[0].getMessage()
    with pytest.raises(RuntimeError, match="native library unavailable"):
        native.finalize_canvas_batch(_u8_images(n=1), CANVAS, [0.5] * 3, [0.5] * 3)
    assert not list((tmp_path / "build").glob("*.so"))
