"""NLVR2 / SNLI-VE / VCR ingestion and fixed-shape pipelines (counterpart of
``feddat_tpu/data/classification_datasets.py``).

Behavioural ports of the reference datasets:
  * NLVR2 (``nlvr2_dataset.py:30-189``): jsonl with identifier ->
    (img0, img1) pair, sentence, boolean label; low-shot per class;
  * SNLI-VE (``snli_ve_dataset.py:34-228``): jsonl over Flickr30K with
    3-way entailment labels;
  * VCR (``vcr_dataset.py:40-248``): 4-choice QA with object-tag text
    substitution (person tags -> gender-neutral names, other objects ->
    "the gray <obj>"); ``qa`` and ``qar`` task types.

Batch schemas match the multi-image and multi-choice forwards of
:class:`feddat_tpu_torch.models.vilt.ViltContinualLearner`; the batches are
bitwise the JAX package's on the same examples.  Images are decoded and
resized on the host per batch (PIL, no u8 cache), as in JAX.  ``shard=(d, D)``
in ``train_batches``/``eval_batches`` assembles only rows
:func:`~feddat_tpu_torch.data.pipeline.shard_rows` of each batch (the SPMD
engine's data rank ``d`` of ``D``).
"""

from __future__ import annotations

import json
import os
import pickle
import random
from dataclasses import dataclass
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from feddat_tpu_torch.data.images import process_vilt_image
from feddat_tpu_torch.data.pipeline import iter_eval_chunks, shard_rows

GENDER_NEUTRAL_NAMES = [
    "Casey", "Riley", "Jessie", "Jackie", "Avery", "Jaime", "Peyton", "Kerry",
    "Jody", "Kendall", "Skyler", "Frankie", "Pat", "Quinn", "Morgan", "Finley",
    "Harley", "Robbie", "Sidney", "Tommie", "Ashley", "Carter", "Adrian",
    "Clarke", "Logan", "Mickey", "Nicky", "Parker", "Tyler", "Reese",
    "Charlie", "Austin", "Denver", "Emerson", "Tatum", "Dallas", "Haven",
    "Jordan", "Robin", "Rory", "Bellamy", "Salem", "Sutton", "Gray", "Shae",
    "Kyle", "Alex", "Ryan", "Cameron", "Dakota",
]


def vcr_tag_text(elements: Sequence, objects: Sequence[str]) -> str:
    """Object-tag substitution, text-exact with the reference
    (``vcr_dataset.py:40-62``): a LIST tag contributes only its LAST
    subelement's name (the reference's inner loop overwrites
    ``temporal_text`` and appends once).  As in JAX, a bare-int tag resolves
    its own index (the reference reads a stale loop variable there)."""

    def name_for(idx: int) -> str:
        if objects[idx] == "person":
            return GENDER_NEUTRAL_NAMES[idx % len(GENDER_NEUTRAL_NAMES)]
        return "the gray " + str(objects[idx]).strip()

    parts: List[str] = []
    for element in elements:
        if isinstance(element, list):
            parts.append(name_for(int(element[-1])))
        elif isinstance(element, int):
            parts.append(name_for(element))
        else:
            parts.append(str(element))
    return " ".join(parts) + " "


def _read_jsonl(path: str) -> Iterator[dict]:
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


# -- example loaders --------------------------------------------------------
@dataclass
class PairedImageExample:  # NLVR2
    image_path_0: str
    image_path_1: str
    text: str
    label: int


@dataclass
class SingleImageExample:  # SNLI-VE
    image_id: object
    text: str
    label: int


@dataclass
class MultiChoiceExample:  # VCR
    image_path: str
    texts: List[str]
    label: int


SNLI_VE_CATEGORIES = ("entailment", "contradiction", "neutral")


def load_nlvr2_examples(data_dir: str, split: str) -> List[PairedImageExample]:
    """``{data_dir}/data/{split}.json`` jsonl (split renamed train/dev/test1,
    ``nlvr2_dataset.py:53-55``), or the ``cached_nlvr2_data`` pickle."""
    rename = {"train": "train", "val": "dev", "test": "test1"}
    _split = rename.get(split, split)
    image_dir = os.path.join(data_dir, "images", _split)
    cache = os.path.join(data_dir, "cached_nlvr2_data", f"{_split}.pkl")
    if os.path.exists(cache):
        with open(cache, "rb") as f:
            raw = pickle.load(f)
        return [PairedImageExample(d["image_id_0"], d["image_id_1"], d["sentence"], d["labels"])
                for d in raw]
    out = []
    for anno in _read_jsonl(os.path.join(data_dir, "data", f"{_split}.json")):
        base = "-".join(anno["identifier"].split("-")[:-1])
        out.append(PairedImageExample(
            image_path_0=os.path.join(image_dir, base + "-img0.png"),
            image_path_1=os.path.join(image_dir, base + "-img1.png"),
            text=str(anno["sentence"]),
            label=0 if str(anno["label"]) == "False" else 1,
        ))
    return out


def load_snli_ve_examples(data_dir: str, split: str) -> List[SingleImageExample]:
    """``{data_dir}/snli_ve_{split}.jsonl``, or the ``cached_ve_data`` pickle."""
    cat2label = {c: i for i, c in enumerate(SNLI_VE_CATEGORIES)}
    cache = os.path.join(data_dir, "cached_ve_data", f"snli-ve_{split}.pkl")
    if os.path.exists(cache):
        with open(cache, "rb") as f:
            raw = pickle.load(f)
        return [SingleImageExample(d["image_id"], d["hypothesis"], d["label"]) for d in raw]
    return [
        SingleImageExample(image_id=int(line["Flickr30K_ID"]), text=str(line["sentence2"]),
                           label=cat2label[line["gold_label"]])
        for line in _read_jsonl(os.path.join(data_dir, f"snli_ve_{split}.jsonl"))
    ]


def load_vcr_examples(data_dir: str, split: str, task_type: str = "qa") -> List[MultiChoiceExample]:
    """Q->A (``qa``) or QA->R (``qar``), choice text = question [SEP] answer
    ([SEP] rationale) (``vcr_dataset.py:96-130``), or the ``cached_vcr_data``
    pickle."""
    cache = os.path.join(data_dir, "cached_vcr_data", f"vcr_{task_type}_{split}.pkl")
    if os.path.exists(cache):
        with open(cache, "rb") as f:
            raw = pickle.load(f)
        return [MultiChoiceExample(d["image_path"], d["texts"], d["label"]) for d in raw]
    out = []
    for line in _read_jsonl(os.path.join(data_dir, "annotation", f"{split}.jsonl")):
        objects = line["objects"]
        question = vcr_tag_text(line["question"], objects)
        if task_type == "qa":
            texts = [question + " [SEP] " + vcr_tag_text(answer, objects)
                     for answer in line["answer_choices"]]
            label = int(line["answer_label"])
        else:
            answer = vcr_tag_text(line["answer_choices"][int(line["answer_label"])], objects)
            texts = [question + " [SEP] " + answer + " [SEP] " + vcr_tag_text(rationale, objects)
                     for rationale in line["rationale_choices"]]
            label = int(line["rationale_label"])
        image_path = os.path.join("drawn_images", str(split), str(task_type),
                                  f"{line['annot_id']}.jpg")
        out.append(MultiChoiceExample(image_path, texts, label))
    return out


def convert_to_low_shot_per_class(examples, num_labels: int, shots_per_class: int, seed: int = 1):
    """Per-class subsampling, draw-exact with the reference
    (``nlvr2_dataset.py:118-131``): a fresh ``random.Random(seed)`` per class
    (a shared generator would select other subsets after the first class)."""
    out = []
    for c in range(num_labels):
        cls = [e for e in examples if e.label == c]
        out.extend(random.Random(seed).sample(cls, min(shots_per_class, len(cls))))
    return out


# -- pipelines ---------------------------------------------------------------
class _BasePipeline:
    def __init__(self, examples, tokenizer, max_text_len, canvas, batch_size, seed=0,
                 eval_examples=None, val_batch_size=None):
        self.examples = list(examples)
        # the eval split (the reference builds its own loaders); the train
        # examples when absent
        self.eval_examples = list(eval_examples) if eval_examples is not None else self.examples
        self.tokenizer = tokenizer
        self.max_text_len = max_text_len
        self.canvas = canvas
        self.batch_size = batch_size
        # the reference's --val_batch_size feeds its eval loaders; default batch_size
        self.val_batch_size = val_batch_size or batch_size
        self.seed = seed
        self.task_key = None

    @property
    def num_train_examples(self):
        return len(self.examples)

    @property
    def num_eval_examples(self):
        return len(self.eval_examples)

    @property
    def steps_per_epoch(self):
        return len(self.examples) // self.batch_size

    def _image(self, source) -> Tuple[np.ndarray, np.ndarray]:
        from PIL import Image

        img = source if hasattr(source, "convert") else Image.open(source)
        return process_vilt_image(img.convert("RGB"), self.canvas)

    def train_batches(self, epoch: int = 0, shard: Tuple[int, int] = (0, 1)):
        rows = shard_rows(self.batch_size, shard)
        order = np.random.RandomState(self.seed * 1000 + epoch).permutation(len(self.examples))
        for s in range(len(order) // self.batch_size):
            sel = order[s * self.batch_size:(s + 1) * self.batch_size][rows]
            yield self._make([self.examples[i] for i in sel])

    def eval_batches(self, shard: Tuple[int, int] = (0, 1)):
        rows = shard_rows(self.val_batch_size, shard)
        for chunk, valid in iter_eval_chunks(self.eval_examples, self.val_batch_size):
            batch = self._make(chunk[rows])
            batch["valid"] = valid[rows]
            yield batch


class Nlvr2Pipeline(_BasePipeline):
    """Two images per example -> pixel_values [B, 2, H, W, 3] (the
    multi-image forward).  The reference halves the batch size for NLVR2
    loaders (``nlvr2_dataset.py:170``); callers pass ``batch_size // 2``."""

    def _make(self, chunk) -> Dict[str, np.ndarray]:
        ids, mask = self.tokenizer.batch_encode([e.text for e in chunk], self.max_text_len)
        pv, pm = [], []
        for e in chunk:
            a, am = self._image(e.image_path_0)
            b, bm = self._image(e.image_path_1)
            pv.append(np.stack([a, b]))
            pm.append(np.stack([am, bm]))
        return {"input_ids": ids, "attention_mask": mask, "pixel_values": np.stack(pv),
                "pixel_mask": np.stack(pm),
                "labels": np.asarray([e.label for e in chunk], np.int64)}


class SnliVePipeline(_BasePipeline):
    def __init__(self, examples, backend, tokenizer, max_text_len, canvas, batch_size,
                 seed=0, eval_examples=None, val_batch_size=None):
        super().__init__(examples, tokenizer, max_text_len, canvas, batch_size, seed,
                         eval_examples=eval_examples, val_batch_size=val_batch_size)
        self.backend = backend

    def _make(self, chunk) -> Dict[str, np.ndarray]:
        ids, mask = self.tokenizer.batch_encode([e.text for e in chunk], self.max_text_len)
        imgs = [self._image(self.backend.path_for(e.image_id)) for e in chunk]
        return {"input_ids": ids, "attention_mask": mask,
                "pixel_values": np.stack([p for p, _ in imgs]),
                "pixel_mask": np.stack([m for _, m in imgs]),
                "labels": np.asarray([e.label for e in chunk], np.int64)}


class VcrPipeline(_BasePipeline):
    """Choices -> input_ids [B, C, L] for the multi-choice forward."""

    def __init__(self, examples, tokenizer, max_text_len, canvas, batch_size, num_choices=4,
                 seed=0, image_root=".", eval_examples=None, val_batch_size=None):
        super().__init__(examples, tokenizer, max_text_len, canvas, batch_size, seed,
                         eval_examples=eval_examples, val_batch_size=val_batch_size)
        self.num_choices = num_choices
        self.image_root = image_root

    def _make(self, chunk) -> Dict[str, np.ndarray]:
        B, C, L = len(chunk), self.num_choices, self.max_text_len
        ids = np.zeros((B, C, L), np.int32)
        mask = np.zeros((B, C, L), np.int32)
        for i, e in enumerate(chunk):
            eid, emask = self.tokenizer.batch_encode(e.texts[:C], L)
            ids[i, :len(e.texts)] = eid
            mask[i, :len(e.texts)] = emask
        imgs = [self._image(os.path.join(self.image_root, e.image_path)) for e in chunk]
        return {"input_ids": ids, "attention_mask": mask,
                "pixel_values": np.stack([p for p, _ in imgs]),
                "pixel_mask": np.stack([m for _, m in imgs]),
                "labels": np.asarray([e.label for e in chunk], np.int64)}
