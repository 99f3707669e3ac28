"""The port's host data path against the JAX package on the CPU: the task
registry, example ingestion (raw JSON, the pickle caches each package writes
and the other reads, low-shot), the ans2label maker, the image backends,
the ViLT and ALBEF pipelines, and ``prefetch_to_device(device="cpu")``.

Everything is compared exactly: the same files give equal examples, labels
and paths, and the pipelines give bitwise equal batches (every key, dtype
and element), with pixels as fp32 and as u8, the u8 cache on and off, and
canvas bucketing on and off."""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from feddat_tpu.configs import tasks as jax_tasks
from feddat_tpu.data import datasets as jax_datasets
from feddat_tpu.data import images as jax_images
from feddat_tpu.data.albef_pipeline import AlbefVQAPipeline as JaxAlbefPipeline
from feddat_tpu.data.make_labels import create_vqa_labels as jax_create_vqa_labels
from feddat_tpu.data.pipeline import ViltVQAPipeline as JaxViltPipeline
from feddat_tpu.data.tokenizer import WordPieceTokenizer as JaxTokenizer
from feddat_tpu_torch.configs import tasks
from feddat_tpu_torch.data import datasets, images
from feddat_tpu_torch.data.albef_pipeline import AlbefVQAPipeline
from feddat_tpu_torch.data.make_labels import VQAV2_ANNOTATION_FILES, create_vqa_labels
from feddat_tpu_torch.data.pipeline import ViltVQAPipeline, iter_eval_chunks, prefetch_to_device
from feddat_tpu_torch.data.synthetic import SyntheticAlbefClient, SyntheticVQAClient
from feddat_tpu_torch.data.tokenizer import WordPieceTokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["what", "is", "the", "color", "of", "this", "how", "many", "red", "blue", "2", "yes"]
ANSWERS = ["red", "blue", "2", "yes", "no", "red car"]
# (w, h) of the fixture's images: landscape, portrait and square, several
# larger than the (64, 96) canvas, so both resize stages and the padding run
SIZES = [(100, 80), (60, 120), (96, 96), (200, 90), (40, 30), (50, 150), (64, 64), (130, 70),
         (30, 60), (96, 40)]


def _examples(mod, n=14, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        k = rng.randint(1, 4)
        answers = [ANSWERS[j] for j in rng.choice(len(ANSWERS), k, replace=False)]
        if i % 3 == 0:
            answers = answers + answers[:1]  # a repeated answer (count-weighted in ALBEF)
        out.append(mod.VQAExample(question_id=i, image_id=f"im{i % len(SIZES)}.jpg",
                                  question=f"what is the color of this {i}",
                                  labels=[ANSWERS.index(a) for a in dict.fromkeys(answers)],
                                  scores=[float(rng.choice([0.3, 0.6, 1.0]))
                                          for _ in dict.fromkeys(answers)],
                                  answers=answers))
    return out


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("images")
    rng = np.random.RandomState(1)
    for i, (w, h) in enumerate(SIZES):
        Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(root / f"im{i}.jpg")
    return str(root)


def _assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_task_registry_is_jax_field_for_field():
    assert [f.name for f in dataclasses.fields(tasks.TaskSpec)] == \
        [f.name for f in dataclasses.fields(jax_tasks.TaskSpec)]
    assert list(tasks.TASK_CONFIGS) == list(jax_tasks.TASK_CONFIGS)
    for key, spec in jax_tasks.TASK_CONFIGS.items():
        assert dataclasses.asdict(tasks.TASK_CONFIGS[key]) == dataclasses.asdict(spec), key
    assert tasks.CLIENT_SETS == jax_tasks.CLIENT_SETS
    for spec in ("domain", "gqa", ("vizwiz", "art")):
        assert tasks.resolve_clients(spec) == jax_tasks.resolve_clients(spec)
    for bad in ("nope", ("gqa", "nope")):
        with pytest.raises(KeyError):
            tasks.resolve_clients(bad)
    custom = tasks.TaskSpec("custom_t", "custom", "custom", "vizwiz", ("train", "val"))
    tasks.register_task(custom)
    try:
        assert tasks.resolve_clients("custom_t") == ("custom_t",)
        with pytest.raises(KeyError, match="already registered"):
            tasks.register_task(custom)
        tasks.register_task(dataclasses.replace(custom, num_labels=7), overwrite=True)
        assert tasks.TASK_CONFIGS["custom_t"].num_labels == 7
    finally:
        del tasks.TASK_CONFIGS["custom_t"]


def _write_raw_split(data_dir, task_key, split, rows):
    """The combined questions-and-annotations JSON of a federated task."""
    os.makedirs(data_dir, exist_ok=True)
    path = os.path.join(data_dir, f"{task_key}_{split}.json")
    with open(path, "w") as f:
        json.dump(rows, f)
    return path


RAW = [{"question_id": 1, "question": "what color", "image": "imgs/pic_7.jpg",
        "answer": ["red", "red", "blue"]},
       {"question_id": 2, "question": "how many", "image": "imgs/pic_8.jpg", "answer": ["2"]},
       {"question_id": 3, "question": "is this", "image": "imgs/pic_9.jpg", "answer": ["maybe"]},
       {"question_id": 4, "question": "what color", "image": "imgs/pic_7.jpg",
        "answer": ["blue", "red", "blue", "blue"]}]


@pytest.mark.parametrize("task_key", ["vizwiz", "toronto", "gqa"])
def test_build_examples_from_json_matches_jax(tmp_path, task_key):
    path = _write_raw_split(str(tmp_path), task_key, "train", RAW)
    a2l = {"red": 0, "blue": 1, "2": 2}
    got = datasets.build_examples_from_json(path, path, a2l, task_key)
    want = jax_datasets.build_examples_from_json(path, path, a2l, task_key)
    assert [e.__dict__ for e in got] == [e.__dict__ for e in want]
    assert len(got) == 3  # the question with no known answer is dropped


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_load_examples_reads_the_other_packages_cache(tmp_path, writer):
    """The raw-JSON build writes a pickle of plain dicts; the other package
    loads it, and both read it alike (shuffled with one seed)."""
    root = str(tmp_path)
    data_dir = os.path.join(root, "vizwiz")
    _write_raw_split(data_dir, "vizwiz", "train", RAW)
    with open(os.path.join(data_dir, "ans2label_fed.pkl"), "wb") as f:
        pickle.dump({"red": 0, "blue": 1, "2": 2}, f)
    first, second = (jax_datasets, datasets) if writer == "jax" else (datasets, jax_datasets)
    built = first.load_examples("vizwiz", data_dir, "train", data_root=root)
    cache = datasets.build_cache_path("vizwiz", data_dir, "train", root)
    assert cache == jax_datasets.build_cache_path("vizwiz", data_dir, "train", root)
    os.remove(os.path.join(data_dir, "vizwiz_train.json"))  # only the cache is left
    read = second.load_examples("vizwiz", data_dir, "train", data_root=root, shuffle_seed=3)
    again = first.load_examples("vizwiz", data_dir, "train", data_root=root, shuffle_seed=3)
    assert type(read[0]).__module__ == second.__name__
    assert [e.__dict__ for e in read] == [e.__dict__ for e in again]
    assert sorted(e.question_id for e in read) == [e.question_id for e in built]


def test_routing_vqav2_and_low_shot_match_jax(tmp_path):
    root = str(tmp_path)
    for key in ("abstract", "toronto", "art", "gqa", "vizwiz", "vqa"):
        for split in ("train", "val_small", "test"):
            args = (key, os.path.join(root, key), split, root)
            assert datasets.cached_data_path(*args) == jax_datasets.cached_data_path(*args)
            assert datasets.build_cache_path(*args) == jax_datasets.build_cache_path(*args)
            assert datasets.raw_json_paths(*args) == jax_datasets.raw_json_paths(*args)
        assert datasets.ans2label_path(key, root, root) == jax_datasets.ans2label_path(key, root, root)
    vqa = tmp_path / "vqa"
    vqa.mkdir()
    with open(vqa / "ans2label.pkl", "wb") as f:
        pickle.dump({"red": 0, "blue": 1}, f)
    json.dump({"questions": [{"question_id": 1, "image_id": 42, "question": "what color?"}]},
              open(vqa / "v2_OpenEnded_mscoco_train2014_questions.json", "w"))
    json.dump({"annotations": [{"question_id": 1, "image_id": 42, "multiple_choice_answer": "red",
                                "answers": [{"answer": "red"}] * 4 + [{"answer": "blue"}] * 2}]},
              open(vqa / "v2_mscoco_train2014_annotations.json", "w"))
    got = datasets.load_vqav2_examples(str(vqa), "train")
    os.remove(vqa / "cached_vqa_data" / "vqa_train.pkl")
    want = jax_datasets.load_vqav2_examples(str(vqa), "train")
    assert [e.__dict__ for e in got] == [e.__dict__ for e in want]
    assert [e.__dict__ for e in datasets.load_vqav2_examples(str(vqa), "train")] == \
        [e.__dict__ for e in want]  # the JAX package's cache, read by the port
    items = list(range(200))
    for pct, seed in ((0.05, 1), (0.3, 7)):
        assert datasets.convert_to_low_shot(items, pct, seed) == \
            jax_datasets.convert_to_low_shot(items, pct, seed)


def test_create_vqa_labels_matches_jax(tmp_path):
    def annos(answers):
        return {"annotations": [{"question_id": i, "multiple_choice_answer": a}
                                for i, a in enumerate(answers)]}

    train = ["red"] * 5 + ["Two"] * 9 + ["rare"] + ["a red"] * 3 + ["The dog."] * 9
    val = ["red"] * 1 + ["Two"] * 2 + ["dont"] * 12
    json.dump(annos(train), open(tmp_path / VQAV2_ANNOTATION_FILES[0], "w"))
    json.dump(annos(val), open(tmp_path / VQAV2_ANNOTATION_FILES[1], "w"))
    files = [str(tmp_path / n) for n in VQAV2_ANNOTATION_FILES]
    for m in (9, 1):
        assert create_vqa_labels(files, m) == jax_create_vqa_labels(files, m)
    assert list(create_vqa_labels(files)) == ["red", "2", "dog", "don't"]
    rc = subprocess.run([sys.executable, "-m", "feddat_tpu_torch.data.make_labels", str(tmp_path)],
                        capture_output=True, text=True, cwd=REPO)
    assert rc.returncode == 0, rc.stderr
    with open(tmp_path / "ans2label.pkl", "rb") as f:
        assert pickle.load(f) == jax_create_vqa_labels(files)


SOURCES = ("vg", "vgd", "vizwiz", "abstract_image", "toronto_image", "art_image", "ms-coco",
           "flickr30k", "vcr")


def test_every_backend_resolves_paths_as_jax(tmp_path):
    """Each source's path convention on a fixture tree (tests/test_data.py:315),
    by ``make_backend``; a missing file decodes to the black fallback."""
    root = tmp_path
    files = {
        "vqa_abstract/train2015/abstract_v002_train2015_000000000020.png": "abstract",
        "vqa_abstract/val2015/abstract_v002_val2015_000000000031.png": "abstract",
        "mscoco/train2014/COCO_train2014_000000000077.jpg": "toronto",
        "mscoco/val2014/COCO_val2014_000000000078.jpg": "toronto",
        "AQUA/SemArt/Images/123-some_painting.jpg": "art",
        "AQUA/SemArt/Images/not-a-number.jpg": "art",
    }
    for rel in files:
        os.makedirs(root / os.path.dirname(rel), exist_ok=True)
        Image.new("RGB", (8, 8), (255, 0, 0)).save(root / rel)
    ids = {"vg": ["n2345", 17], "vgd": ["2345"], "vizwiz": ["VizWiz_train_00000001.jpg"],
           "abstract_image": [20, 31, "abstract_v002_train2015_000000000020"],
           "toronto_image": [77, 78, "COCO_val2014_000000000078"],
           "art_image": [123, "123-some_painting"], "ms-coco": [77, "78"],
           "flickr30k": ["1000092795"], "vcr": ["drawn_images/train/x.jpg"]}
    for source in SOURCES:
        got = images.make_backend(source, "t", str(root))
        want = jax_images.make_backend(source, "t", str(root))
        assert type(got).__name__ == type(want).__name__
        for image_id in ids[source]:
            assert got.path_for(image_id) == want.path_for(image_id), (source, image_id)
    art = images.make_backend("art_image", "t", str(root))
    assert np.asarray(art.load("123-some_painting"))[0, 0, 0] > 200  # the red image, as a JPEG
    assert np.asarray(art.load(999)).max() == 0 and art.load(999).size == (384, 384)
    with pytest.raises(KeyError):
        images.make_backend("nope", "t", str(root))


def test_host_image_functions_match_jax(image_dir):
    for i, (w, h) in enumerate(SIZES):
        img = Image.open(os.path.join(image_dir, f"im{i}.jpg")).convert("RGB")
        for canvas in ((64, 96), (384, 640)):
            assert images.vilt_resized_dims(w, h, canvas) == jax_images.vilt_resized_dims(w, h, canvas)
            for a, b in zip(images.process_vilt_image(img, canvas),
                            jax_images.process_vilt_image(img, canvas)):
                np.testing.assert_array_equal(a, b)
            u8 = images.vilt_resized_u8(img, canvas)
            assert u8.shape[:2] == images.vilt_resized_dims(w, h, canvas)
        np.testing.assert_array_equal(images.process_albef_image(img, 32),
                                      jax_images.process_albef_image(img, 32))


def _vilt_pipes(image_dir, **kw):
    common = dict(num_labels=len(ANSWERS), max_text_len=10, canvas=(64, 96), batch_size=4,
                  val_batch_size=3, seed=2, num_workers=2, **kw)
    port = ViltVQAPipeline(_examples(datasets), images.VizwizBackend(image_dir),
                           WordPieceTokenizer.toy(WORDS), eval_examples=_examples(datasets, 7, 1),
                           **common)
    jax = JaxViltPipeline(_examples(jax_datasets), jax_images.VizwizBackend(image_dir),
                          JaxTokenizer.toy(WORDS), eval_examples=_examples(jax_datasets, 7, 1),
                          **common)
    return port, jax


@pytest.mark.parametrize("pixels_u8", [False, True])
@pytest.mark.parametrize("cache_images", [False, True])
@pytest.mark.parametrize("canvas_bucket", [False, True])
def test_vilt_pipeline_batches_are_bitwise_jax(image_dir, pixels_u8, cache_images, canvas_bucket):
    port, jax = _vilt_pipes(image_dir, pixels_u8=pixels_u8, cache_images=cache_images,
                            canvas_bucket=canvas_bucket)
    for epoch in (0, 1001):
        _assert_batches_equal(port.train_batches(epoch), jax.train_batches(epoch))
    _assert_batches_equal(port.eval_batches(), jax.eval_batches())
    assert port.steps_per_epoch == jax.steps_per_epoch == 3
    evals = list(port.eval_batches())
    assert [e["valid"].tolist() for e in evals] == [[1, 1, 1], [1, 1, 1], [1, 0, 0]]
    if canvas_bucket:
        shapes = {b["pixel_values"].shape[1:3] for b in port.train_batches(0)}
        assert (64, 64) in shapes and {e["pixel_values"].shape[1:3] for e in evals} == {(64, 96)}
    if cache_images:  # a second epoch from the cache: the same pixels
        assert len(port._cache) == len(SIZES)
        _assert_batches_equal(port.train_batches(0), jax.train_batches(0))


def test_eval_chunks_pad_with_the_first_example():
    chunks = list(iter_eval_chunks(list("abcdefg"), 3))
    assert [c for c, _ in chunks] == [list("abc"), list("def"), list("gaa")]
    assert [v.tolist() for _, v in chunks] == [[1, 1, 1], [1, 1, 1], [1, 0, 0]]
    assert all(v.dtype == np.float32 for _, v in chunks)


@pytest.mark.parametrize("pixels_u8", [False, True])
@pytest.mark.parametrize("cache_images", [False, True])
def test_albef_pipeline_batches_are_bitwise_jax(image_dir, pixels_u8, cache_images):
    common = dict(image_size=32, max_question_len=8, max_answer_len=4, max_answers_per_q=3,
                  gt_pad=4, batch_size=4, val_batch_size=3, seed=1, num_workers=2,
                  pixels_u8=pixels_u8, cache_images=cache_images)
    port = AlbefVQAPipeline(_examples(datasets), images.VizwizBackend(image_dir),
                            WordPieceTokenizer.toy(WORDS), ANSWERS,
                            eval_examples=_examples(datasets, 7, 1), **common)
    jax = JaxAlbefPipeline(_examples(jax_datasets), jax_images.VizwizBackend(image_dir),
                           JaxTokenizer.toy(WORDS), ANSWERS,
                           eval_examples=_examples(jax_datasets, 7, 1), **common)
    np.testing.assert_array_equal(port.answer_ids, jax.answer_ids)
    np.testing.assert_array_equal(port.answer_mask, jax.answer_mask)
    for epoch in (0, 3):
        _assert_batches_equal(port.train_batches(epoch), jax.train_batches(epoch))
    _assert_batches_equal(port.eval_batches(), jax.eval_batches())
    weights = next(port.train_batches(0))["answer_weights"]
    np.testing.assert_allclose(weights.sum(-1), 1.0, rtol=1e-6)


def _port_client(kind, image_dir):
    """A port client with train and eval batches of 4 rows."""
    if kind == "albef":
        return AlbefVQAPipeline(_examples(datasets), images.VizwizBackend(image_dir),
                                WordPieceTokenizer.toy(WORDS), ANSWERS,
                                eval_examples=_examples(datasets, 7, 1), image_size=32,
                                max_question_len=8, max_answer_len=4, batch_size=4, seed=1,
                                num_workers=2)
    if kind.startswith("synthetic"):
        return (SyntheticAlbefClient("t") if kind == "synthetic_albef"
                else SyntheticVQAClient("t", num_eval=14))
    return ViltVQAPipeline(_examples(datasets), images.VizwizBackend(image_dir),
                           WordPieceTokenizer.toy(WORDS), num_labels=len(ANSWERS),
                           max_text_len=10, canvas=(64, 96), batch_size=4, seed=2,
                           eval_examples=_examples(datasets, 7, 1), num_workers=2,
                           canvas_bucket=kind == "vilt_bucket")


@pytest.mark.parametrize("kind", ["vilt", "vilt_bucket", "albef", "synthetic_vqa", "synthetic_albef"])
def test_a_shard_assembles_its_rows_of_the_whole_batch(image_dir, kind):
    """``shard=(d, D)`` (the SPMD engine's data rank d of D) gives rows
    [d·B/D, (d+1)·B/D) of each whole batch, bitwise, eval padding included;
    a batch that does not split raises."""
    client = _port_client(kind, image_dir)
    for whole_fn, part_fn in ((lambda: client.train_batches(5),
                               lambda d: client.train_batches(5, shard=(d, 2))),
                              (client.eval_batches, lambda d: client.eval_batches(shard=(d, 2)))):
        whole, parts = list(whole_fn()), [list(part_fn(d)) for d in range(2)]
        assert len(whole) == len(parts[0]) == len(parts[1]) > 0
        for i, w in enumerate(whole):
            _assert_batches_equal([{k: np.concatenate([parts[0][i][k], parts[1][i][k]])
                                    for k in w}], [w])
    with pytest.raises(ValueError, match="does not split over 3 data ranks"):
        next(client.train_batches(0, shard=(0, 3)))


def test_prefetch_on_the_cpu_hands_over_every_batch_as_tensors():
    batches = [{"x": np.full((2, 3), i, np.float32), "n": np.arange(i + 1)} for i in range(5)]
    got = list(prefetch_to_device(iter(batches), size=2, device="cpu"))
    assert len(got) == 5
    for g, b in zip(got, batches):
        assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu" for v in g.values())
        assert all(np.array_equal(g[k].numpy(), b[k]) for k in b)


def test_prefetch_propagates_producer_errors():
    """A failure in the producer reaches the consumer instead of looking
    like the end of the epoch (tests/test_data.py:271)."""
    def bad_iter():
        yield {"x": np.zeros((4, 2), np.float32)}
        raise RuntimeError("boom in producer")

    it = prefetch_to_device(bad_iter(), size=2, device="cpu")
    assert next(it)["x"].shape == (4, 2)
    with pytest.raises(RuntimeError, match="boom in producer"):
        next(it)


def test_prefetch_abandonment_stops_the_producer():
    """A consumer that drops the generator early releases the producer
    thread (tests/test_data.py:288)."""
    produced = []

    def source():
        for i in range(100):
            produced.append(i)
            yield {"x": np.full((2,), i, np.float32)}

    before = threading.active_count()
    it = prefetch_to_device(source(), size=2, device="cpu")
    assert next(it)["x"][0] == 0
    it.close()
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before, "the producer thread leaked"
    assert len(produced) < 100


def test_u8_cache_charges_each_image_once_under_concurrent_loads(image_dir):
    """The pool loads one image for several questions at once: with more
    workers than cores and a short switch interval, every image is cached
    once and the budget is charged once per image."""
    examples = [datasets.VQAExample(i, f"im{i % len(SIZES)}.jpg", "what", [0], [1.0], ["red"])
                for i in range(8 * len(SIZES))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pipe = ViltVQAPipeline(examples, images.VizwizBackend(image_dir), WordPieceTokenizer.toy(WORDS),
                               num_labels=len(ANSWERS), max_text_len=6, canvas=(64, 96),
                               batch_size=len(examples), num_workers=4 * (os.cpu_count() or 1),
                               cache_images=True, pixels_u8=True)
        batch = next(pipe.train_batches(0))
    finally:
        sys.setswitchinterval(interval)
    assert len(pipe._cache) == len(SIZES)
    assert pipe._cache_left == (8 << 30) - sum(a.nbytes for a in pipe._cache.values())
    assert batch["pixel_values"].shape == (len(examples), 64, 96, 3)
