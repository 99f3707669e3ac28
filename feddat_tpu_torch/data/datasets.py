"""VQA example ingestion (copy of ``feddat_tpu/data/datasets.py``; the
reference's ``VQADataset`` load paths,
``src/data/visionlanguage_datasets/vqa_dataset_crossvqa.py:32-375``).

Split into pure functions: ``load_ans2label`` (per-task pickle routing),
``load_examples`` (cached-pickle fast path incl. the ``_fed`` subsampled
variants, or the raw-JSON build path with answer counting and per-dataset
soft-score rules).  The pickle caches hold plain dicts (``VQAExample``'s
fields), so the two packages read each other's caches.
Batching/preprocessing lives in :mod:`feddat_tpu_torch.data.pipeline` (the
reference does it inside torch Dataset
``__getitem__`` + collators).
"""

from __future__ import annotations

import json
import os
import pickle
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from feddat_tpu_torch.data.vqa_scoring import get_score

# Datasets whose soft score is 1/occurrences instead of the VQA 0.3/0.6/0.9/1
# table (reference ``vqa_dataset_crossvqa.py:232-236``).
UNIFORM_SCORE_TASKS = ("toronto", "pvqa", "med", "art", "gqa")

CLOVE_FUNCTION_KEYS = {
    "a": "attribute",
    "b": "knowledge",
    "c": "logical",
    "d": "object",
    "e": "relation",
}


@dataclass
class VQAExample:
    question_id: Any
    image_id: Any
    question: str
    labels: List[int]
    scores: List[float]
    answers: List[str]
    question_input_ids: List[int] = field(default_factory=list)


def ans2label_path(task_key: str, data_dir: str, data_root: str = "./data") -> str:
    """Per-task ans2label pickle routing (``vqa_dataset_crossvqa.py:74-118``)."""
    if "abstract" in task_key:
        return os.path.join(data_root, "abstract", "ans2label.pkl")
    if "toronto" in task_key:
        return os.path.join(data_root, "toronto", "ans2label.pkl")
    if "art" in task_key:
        return os.path.join(data_root, "art", "ans2label_small.pkl")
    if "gqa" in task_key:
        return os.path.join(data_root, "GQA", "ans2label_fed.pkl")
    if "vizwiz" in task_key:
        return os.path.join(data_root, "vizwiz", "ans2label_fed.pkl")
    if "clove_scene" in task_key:
        scene_key = task_key.replace("clove_", "")
        root = os.path.join(data_root, "CLOVE", "json", "scene")
        for fname in sorted(os.listdir(root)):
            if scene_key in fname and "ans2label" in fname:
                return os.path.join(root, fname)
        raise FileNotFoundError(f"no ans2label for {task_key} in {root}")
    if "clove_function" in task_key:
        fkey = CLOVE_FUNCTION_KEYS[task_key.replace("clove_function_", "")]
        root = os.path.join(data_root, "CLOVE", "json", "function")
        for fname in sorted(os.listdir(root)):
            if fkey in fname and "ans2label" in fname:
                return os.path.join(root, fname)
        raise FileNotFoundError(f"no ans2label for {task_key} in {root}")
    return os.path.join(data_dir, "ans2label.pkl")


def load_ans2label(task_key: str, data_dir: str, data_root: str = "./data") -> Dict[str, int]:
    with open(ans2label_path(task_key, data_dir, data_root), "rb") as f:
        return pickle.load(f)


def cached_data_path(
    task_key: str, data_dir: str, split: str, data_root: str = "./data"
) -> str:
    """Cached-pickle routing incl. ``_fed`` subsampled variants
    (``vqa_dataset_crossvqa.py:125-147``)."""
    if split == "test":
        split = "test_small"
    if task_key in ("gqa", "vizwiz"):
        return os.path.join(data_dir, f"{split.split('_')[0]}_fed.pkl")
    if "clove" in task_key:
        a2l = ans2label_path(task_key, data_dir, data_root)
        key = "val" if "test" in split else split.split("_")[0]
        return a2l.replace("ans2label", key)
    base = os.path.join(data_dir, "cached_vqa_data", f"vqa_{split}.pkl")
    return base.replace(".pkl", "_fed.pkl")


def build_cache_path(task_key: str, data_dir: str, split: str, data_root: str = "./data") -> str:
    """Where locally-built (raw-JSON) example pickles are cached.  For the
    ``cached_vqa_data`` tasks this is the non-``_fed`` base name — the
    ``_fed`` files are EXTERNALLY-produced subsamples (the reference also
    dumps builds to the base name, ``vqa_dataset_crossvqa.py:249``); a local
    full build must never be re-loaded as if it were the fed subsample."""
    p = cached_data_path(task_key, data_dir, split, data_root)
    return p.replace("_fed.pkl", ".pkl") if p.endswith("_fed.pkl") else p + ".built"


def raw_json_paths(task_key: str, data_dir: str, split: str, data_root: str = "./data"):
    """(questions_file, annotations_file) for the raw build path
    (``vqa_dataset_crossvqa.py:74-96``)."""
    if split == "test":
        split = "test_small"
    if "abstract" in task_key:
        return (
            os.path.join(data_dir, f"abstract_{split}.json"),
            os.path.join(data_dir, "abstract_v002_val2015_annotations.json"),
        )
    if "toronto" in task_key:
        p = os.path.join(data_dir, f"toronto_{split}.json")
        return p, p
    if "art" in task_key:
        p = os.path.join(data_root, "art", f"art_{split}.json")
        return p, p
    p = os.path.join(data_dir, f"{task_key}_{split}.json")
    return p, p


def build_examples_from_json(
    questions_file: str,
    annotations_file: str,
    ans2label: Dict[str, int],
    task_key: str,
    tokenizer=None,
) -> List[VQAExample]:
    """Raw-JSON build path (``vqa_dataset_crossvqa.py:171-251``): parse
    image ids from filename stems, count crowd answers, attach soft scores."""
    with open(questions_file) as f:
        questions = json.load(f)
    qid2qdata = {x["question_id"]: x for x in questions}
    with open(annotations_file) as f:
        annotations = json.load(f)

    uniform = any(t in task_key for t in UNIFORM_SCORE_TASKS)
    examples: List[VQAExample] = []
    missing_q = 0
    for anno in annotations:
        qid = anno["question_id"]
        fname = anno["image"].split("/")[-1]
        # vizwiz image ids ARE filenames (``VizwizBackend``); every other
        # backend keys on the extensionless stem (reference live parse,
        # ``vqa_dataset_crossvqa.py:194``)
        image_id = fname if "vizwiz" in task_key else fname.split(".")[0]
        # annotations can outnumber the split's questions (abstract pairs a
        # PER-SPLIT questions file with the full val2015 annotations file,
        # ``raw_json_paths``): skip those instead of the reference's
        # unguarded KeyError (``vqa_dataset_crossvqa.py:199``) — a
        # deliberate robustness deviation, counted and reported below
        qdata = qid2qdata.get(qid)
        if qdata is None:
            missing_q += 1
            continue
        question = qdata["question"]
        input_ids: List[int] = []
        if tokenizer is not None:
            input_ids = tokenizer.convert_tokens_to_ids(tokenizer.tokenize(question))

        answer_count: Dict[str, int] = defaultdict(int)
        for ans in anno["answer"]:
            answer_count[ans] += 1

        labels, scores, answers = [], [], []
        for answer, count in answer_count.items():
            if answer not in ans2label:
                continue
            labels.append(ans2label[answer])
            scores.append(1.0 / count if uniform else get_score(count))
            answers.append(answer)
        if not answers:
            continue
        examples.append(
            VQAExample(
                question_id=qid,
                image_id=image_id,
                question=question,
                labels=labels,
                scores=scores,
                answers=answers,
                question_input_ids=input_ids,
            )
        )
    if missing_q:
        import logging

        logging.getLogger("feddat_tpu_torch").warning(
            "%s/%s: %d annotations had no question in this split's "
            "questions file (skipped)", task_key, questions_file, missing_q,
        )
    return examples


def load_examples(
    task_key: str,
    data_dir: str,
    split: str,
    data_root: str = "./data",
    tokenizer=None,
    shuffle_seed: Optional[int] = None,
) -> List[VQAExample]:
    """Cached-pickle fast path with raw-JSON fallback
    (``vqa_dataset_crossvqa.py:125-251``).  The reference shuffles cached
    data with global ``random``; here the shuffle is explicit and seeded."""
    cache = cached_data_path(task_key, data_dir, split, data_root)
    built = build_cache_path(task_key, data_dir, split, data_root)
    if not os.path.isfile(cache) and os.path.isfile(built):
        cache = built  # a previous local raw-JSON build (never the fed file)
    if os.path.isfile(cache):
        with open(cache, "rb") as f:
            raw = pickle.load(f)
        examples = [
            VQAExample(
                question_id=d.get("question_id"),
                image_id=d.get("image_id"),
                question=d.get("question", ""),
                labels=list(d.get("labels", [])),
                scores=list(d.get("scores", [])),
                answers=list(d.get("answers", [])),
                question_input_ids=list(d.get("question_input_ids", []) or []),
            )
            for d in raw
        ]
    else:
        ans2label = load_ans2label(task_key, data_dir, data_root)
        qf, af = raw_json_paths(task_key, data_dir, split, data_root)
        examples = build_examples_from_json(qf, af, ans2label, task_key, tokenizer)
        os.makedirs(os.path.dirname(built), exist_ok=True)
        with open(built, "wb") as f:
            pickle.dump(
                [e.__dict__ for e in examples], f
            )
    if shuffle_seed is not None:
        import numpy as np

        rng = np.random.RandomState(shuffle_seed)
        rng.shuffle(examples)
    return examples


def load_vqav2_examples(
    data_dir: str,
    split: str,
    tokenizer=None,
) -> List[VQAExample]:
    """VQAv2 (non-federated) ingestion (reference ``vqa_dataset.py:34-185``):
    ``v2_OpenEnded_mscoco_{split}2014_questions.json`` +
    ``v2_mscoco_{split}2014_annotations.json`` + ``ans2label.pkl`` (3129
    labels), crowd answers scored by the VQA occurrence table."""
    with open(os.path.join(data_dir, "ans2label.pkl"), "rb") as f:
        ans2label = pickle.load(f)
    cache = os.path.join(data_dir, "cached_vqa_data", f"vqa_{split}.pkl")
    if os.path.isfile(cache):
        with open(cache, "rb") as f:
            raw = pickle.load(f)
        return [
            VQAExample(
                question_id=d["question_id"],
                image_id=d["image_id"],
                question=d["question"],
                labels=list(d["labels"]),
                scores=list(d["scores"]),
                answers=list(d["answers"]),
                question_input_ids=list(d.get("question_input_ids", []) or []),
            )
            for d in raw
        ]
    with open(os.path.join(data_dir, f"v2_OpenEnded_mscoco_{split}2014_questions.json")) as f:
        questions = json.load(f)["questions"]
    qid2qdata = {x["question_id"]: x for x in questions}
    with open(os.path.join(data_dir, f"v2_mscoco_{split}2014_annotations.json")) as f:
        annotations = json.load(f)["annotations"]
    examples = []
    for anno in annotations:
        qid = anno["question_id"]
        qdata = qid2qdata[qid]
        question = qdata["question"]
        input_ids = (
            tokenizer.convert_tokens_to_ids(tokenizer.tokenize(question))
            if tokenizer is not None
            else []
        )
        counts: Dict[str, int] = defaultdict(int)
        for a in anno["answers"]:
            counts[a["answer"]] += 1
        labels, scores, answers = [], [], []
        for answer, c in counts.items():
            if answer not in ans2label:
                continue
            labels.append(ans2label[answer])
            scores.append(get_score(c))
            answers.append(answer)
        examples.append(
            VQAExample(
                question_id=qid,
                image_id=anno["image_id"],
                question=question,
                labels=labels,
                scores=scores,
                answers=answers,
                question_input_ids=input_ids,
            )
        )
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    with open(cache, "wb") as f:
        pickle.dump([e.__dict__ for e in examples], f)
    return examples


def convert_to_low_shot(examples: List[VQAExample], pct: float, seed: int = 1) -> List[VQAExample]:
    """Low-shot subsampling, DRAW-EXACT with the reference
    (``vqa_dataset.py:172-183``: ``random.Random(1).sample`` over
    ``int(pct * n)`` examples) so the same seed selects the same subset."""
    import random

    n = int(len(examples) * pct)
    return random.Random(seed).sample(examples, n)
