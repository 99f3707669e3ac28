"""The port's NLVR2 / SNLI-VE / VCR ingestion and pipelines
(``data/classification_datasets.py``) against the JAX package's on the CPU.

A small dataset in each task's reference layout is written under a tmp dir
by ``chip_smoke.py::write_classification_dataset`` (the writer the card's
``classify`` phase uses): NLVR2's ``data/{train,dev}.json`` and
``images/<split>/*-img{0,1}.png``, SNLI-VE's ``snli_ve_{split}.jsonl`` over
Flickr30K ids, VCR's ``annotation/{split}.jsonl`` and ``drawn_images``, and
VQAv2's questions, annotations and ``ans2label.pkl`` over COCO ids.  Exact:
every loader's examples (from the files and from their pickle caches), the
low-shot draws, ``vcr_tag_text``, and every pipeline's train and eval
batches bitwise (keys, shapes, dtypes, values, ``valid``); a data rank's
``shard=(d, D)`` batches are rows ``[d·B/D, (d+1)·B/D)`` of the whole ones."""

import dataclasses
import os
import pathlib
import pickle
import sys

import numpy as np
import pytest

import feddat_tpu.data.classification_datasets as jcd
import feddat_tpu_torch.data.classification_datasets as tcd
from feddat_tpu.data.datasets import convert_to_low_shot as jax_low_shot
from feddat_tpu.data.datasets import load_vqav2_examples as jax_load_vqav2
from feddat_tpu.data.images import make_backend as jax_make_backend
from feddat_tpu.data.pipeline import ViltVQAPipeline as JaxVqaPipeline
from feddat_tpu.data.tokenizer import WordPieceTokenizer as JaxTokenizer
from feddat_tpu_torch.data.datasets import convert_to_low_shot, load_vqav2_examples
from feddat_tpu_torch.data.images import make_backend
from feddat_tpu_torch.data.pipeline import ViltVQAPipeline
from feddat_tpu_torch.data.tokenizer import WordPieceTokenizer

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

VOCAB = str(ROOT / "tests" / "fixtures" / "vocab30k.txt")
COUNTS = {"nlvr2": (10, 6), "snli-ve": (12, 7), "vcr": (120, 60), "vqa": (120, 60)}
SIZES = ((40, 30), (30, 52), (64, 64), (50, 20))
CANVAS, TEXT_LEN = (64, 96), 16


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = tmp_path_factory.mktemp("classification")
    chip_smoke.write_classification_dataset(str(path), 0, COUNTS, SIZES)
    return path


@pytest.fixture(scope="module")
def toks():
    return JaxTokenizer.from_vocab_file(VOCAB), WordPieceTokenizer.from_vocab_file(VOCAB)


def same_examples(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert type(g).__name__ == type(w).__name__
        assert dataclasses.asdict(g) == dataclasses.asdict(w)


LOADS = [
    ("nlvr2", "load_nlvr2_examples", ("train",)), ("nlvr2", "load_nlvr2_examples", ("val",)),
    ("snli-ve", "load_snli_ve_examples", ("train",)), ("snli-ve", "load_snli_ve_examples", ("dev",)),
    ("vcr", "load_vcr_examples", ("train", "qa")), ("vcr", "load_vcr_examples", ("val", "qar")),
]


@pytest.mark.parametrize("task,fn,args", LOADS, ids=[f"{f}{a}" for _, f, a in LOADS])
def test_loaders_match_jax(root, task, fn, args):
    data_dir = str(root / task)
    same_examples(getattr(tcd, fn)(data_dir, *args), getattr(jcd, fn)(data_dir, *args))


def test_loaders_read_their_pickle_caches_as_jax(tmp_path):
    """Each loader's cache pickle (the reference's preprocessed form) wins
    over the raw files, in both packages."""
    rows = {
        ("cached_nlvr2_data", "dev.pkl"): [{"image_id_0": "a.png", "image_id_1": "b.png",
                                            "sentence": "two dogs", "labels": 1}],
        ("cached_ve_data", "snli-ve_train.pkl"): [{"image_id": 7, "hypothesis": "a cat",
                                                   "label": 2}],
        ("cached_vcr_data", "vcr_qar_val.pkl"): [{"image_path": "x.jpg", "texts": ["a", "b"],
                                                  "label": 1}],
    }
    for (sub, name), data in rows.items():
        (tmp_path / sub).mkdir()
        with open(tmp_path / sub / name, "wb") as f:
            pickle.dump(data, f)
    d = str(tmp_path)
    for fn, args in (("load_nlvr2_examples", ("val",)), ("load_snli_ve_examples", ("train",)),
                     ("load_vcr_examples", ("val", "qar"))):
        same_examples(getattr(tcd, fn)(d, *args), getattr(jcd, fn)(d, *args))


def test_vcr_tag_text_matches_jax():
    objects = ["person", "dog", "person", " cup "] + ["person"] * 60
    rng = np.random.RandomState(0)
    cases = [["what", "is", [0], "doing"], ["are", [0, 2], "talking", [3]], [1, "and", 63], []]
    cases += [[[int(rng.randint(64))] if rng.rand() < 0.4 else str(rng.randint(9)) for _ in range(8)]
              for _ in range(20)]
    for elements in cases:
        assert tcd.vcr_tag_text(elements, objects) == jcd.vcr_tag_text(elements, objects)


@pytest.mark.parametrize("shots,seed", [(3, 1), (5, 7), (100, 1)])
def test_low_shot_per_class_draws_as_jax(root, shots, seed):
    ex = tcd.load_snli_ve_examples(str(root / "snli-ve"), "train")
    want = jcd.convert_to_low_shot_per_class(jcd.load_snli_ve_examples(str(root / "snli-ve"), "train"),
                                             3, shots, seed=seed)
    same_examples(tcd.convert_to_low_shot_per_class(ex, 3, shots, seed=seed), want)


def pipelines(root, toks, eval_batch=None):
    """(JAX, port) pipelines of each task, as the CLI builds them at B=4."""
    jt, tt = toks
    out = {}
    for mod, tok, pkg in ((jcd, jt, "jax"), (tcd, tt, "port")):
        nl = str(root / "nlvr2")
        sn, vc = str(root / "snli-ve"), str(root / "vcr")
        backend = (jax_make_backend if pkg == "jax" else make_backend)("flickr30k", "snli-ve",
                                                                      str(root))
        out[pkg] = {
            "nlvr2": mod.Nlvr2Pipeline(mod.load_nlvr2_examples(nl, "train"), tok, TEXT_LEN, CANVAS,
                                       2, seed=3, eval_examples=mod.load_nlvr2_examples(nl, "val"),
                                       val_batch_size=eval_batch),
            "snli-ve": mod.SnliVePipeline(mod.load_snli_ve_examples(sn, "train"), backend, tok,
                                          TEXT_LEN, CANVAS, 4, seed=3,
                                          eval_examples=mod.load_snli_ve_examples(sn, "dev"),
                                          val_batch_size=eval_batch),
            "vcr": mod.VcrPipeline(mod.load_vcr_examples(vc, "train")[:12], tok, TEXT_LEN, CANVAS, 4,
                                   num_choices=4, seed=3, image_root=vc,
                                   eval_examples=mod.load_vcr_examples(vc, "val")[:7],
                                   val_batch_size=eval_batch),
        }
    return out


def same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("task", ["nlvr2", "snli-ve", "vcr"])
def test_pipeline_batches_are_jaxs_bitwise(root, toks, task):
    pipes = pipelines(root, toks)
    j, t = pipes["jax"][task], pipes["port"][task]
    assert t.steps_per_epoch == j.steps_per_epoch > 0
    assert (t.num_train_examples, t.num_eval_examples) == (j.num_train_examples, j.num_eval_examples)
    for epoch in (0, 1):
        same_batches(t.train_batches(epoch), j.train_batches(epoch))
    same_batches(t.eval_batches(), j.eval_batches())
    last = list(t.eval_batches())[-1]
    assert "valid" in last and last["valid"].dtype == np.float32
    b = next(t.train_batches(0))
    rows = 2 if task == "nlvr2" else 4
    assert b["labels"].shape == (rows,) and b["labels"].dtype == np.int64
    if task == "nlvr2":
        assert b["pixel_values"].shape == (rows, 2, *CANVAS, 3)
    if task == "vcr":
        assert b["input_ids"].shape == (rows, 4, TEXT_LEN)


@pytest.mark.parametrize("task", ["nlvr2", "snli-ve", "vcr"])
def test_a_data_ranks_shard_is_its_rows_of_the_batch(root, toks, task):
    pipe = pipelines(root, toks, eval_batch=4)["port"][task]
    D = 2
    for whole, *parts in zip(pipe.train_batches(1), *[pipe.train_batches(1, shard=(d, D))
                                                      for d in range(D)]):
        for k in whole:
            np.testing.assert_array_equal(np.concatenate([p[k] for p in parts]), whole[k])
    for whole, *parts in zip(pipe.eval_batches(), *[pipe.eval_batches(shard=(d, D))
                                                    for d in range(D)]):
        for k in whole:
            np.testing.assert_array_equal(np.concatenate([p[k] for p in parts]), whole[k])
    with pytest.raises(ValueError, match="does not split"):
        next(pipe.eval_batches(shard=(0, 3)))


def test_low_shot_vqav2_client_is_jaxs(root, toks):
    """The CLI's VQAv2 client: the 5% low-shot draw with the fixed seed 1,
    then the ViLT VQA pipeline, batches bitwise JAX's."""
    jt, tt = toks
    data_dir = str(root / "vqav2")
    ex = convert_to_low_shot(load_vqav2_examples(data_dir, "train", tt), 0.05, seed=1)
    want = jax_low_shot(jax_load_vqav2(data_dir, "train", jt), 0.05, seed=1)
    assert len(ex) == len(want) == 6
    assert [dataclasses.asdict(e) for e in ex] == [dataclasses.asdict(e) for e in want]
    kw = dict(num_labels=3129, batch_size=3, seed=2, canvas=CANVAS, max_text_len=TEXT_LEN,
              num_workers=0)
    t = ViltVQAPipeline(ex, make_backend("ms-coco", "vqa", str(root)), tt, **kw)
    j = JaxVqaPipeline(want, jax_make_backend("ms-coco", "vqa", str(root)), jt, **kw)
    same_batches(t.train_batches(0), j.train_batches(0))
    assert os.path.exists(os.path.join(data_dir, "cached_vqa_data", "vqa_train.pkl"))
