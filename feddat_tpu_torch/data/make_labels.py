"""Offline ans2label construction (copy of ``feddat_tpu/data/make_labels.py``; the
reference's ``create_vqa_labels``).

Counts VQA-eval-normalized ``multiple_choice_answer`` values over VQAv2-style
annotation JSONs and writes the answer-vocabulary pickle consumed by
``data/datasets.py::load_ans2label``.  Behavior match:
the reference's ``src/utils/vqa_utils.py:34-48`` — answers from BOTH the
train and val annotation files, kept iff their normalized form occurs at
least 9 times, labeled in first-occurrence order.

Runnable: ``python -m feddat_tpu_torch.data.make_labels <vqa_dir>`` (expects the
standard ``v2_mscoco_{train,val}2014_annotations.json`` names and writes
``<vqa_dir>/ans2label.pkl``), or with explicit ``--annotations``/``--out``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import pickle
from collections import Counter
from typing import Dict, Sequence

from feddat_tpu_torch.data.text import normalize_word

logger = logging.getLogger(__name__)

VQAV2_ANNOTATION_FILES = (
    "v2_mscoco_train2014_annotations.json",
    "v2_mscoco_val2014_annotations.json",
)


def create_vqa_labels(
    annotation_files: Sequence[str], min_occurrences: int = 9
) -> Dict[str, int]:
    """Build the answer->label map from annotation JSONs.

    Each file is ``{"annotations": [{"multiple_choice_answer": str, ...}]}``;
    answers are VQA-eval-normalized, counted across ALL files, and kept iff
    their count is >= ``min_occurrences``.  Label ids follow first-occurrence
    order (Counter preserves insertion order, matching the reference's
    ``{k: i for i, k in enumerate(counter.keys())}``).
    """
    counts: Counter = Counter()
    for path in annotation_files:
        with open(path) as f:
            annotations = json.load(f)["annotations"]
        counts.update(
            normalize_word(anno["multiple_choice_answer"]) for anno in annotations
        )
    ans2label = {
        answer: i
        for i, answer in enumerate(
            a for a, n in counts.items() if n >= min_occurrences
        )
    }
    logger.info(
        "ans2label: %d answers kept (>=%d occurrences) of %d distinct",
        len(ans2label), min_occurrences, len(counts),
    )
    return ans2label


def write_vqa_labels(
    annotation_files: Sequence[str], out_path: str, min_occurrences: int = 9
) -> Dict[str, int]:
    ans2label = create_vqa_labels(annotation_files, min_occurrences)
    with open(out_path, "wb") as f:
        pickle.dump(ans2label, f)
    return ans2label


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "vqa_dir", nargs="?",
        help="directory holding the standard VQAv2 annotation files; "
        "ans2label.pkl is written next to them",
    )
    parser.add_argument(
        "--annotations", nargs="+",
        help="explicit annotation JSON paths (overrides the vqa_dir layout)",
    )
    parser.add_argument("--out", help="output pickle path")
    parser.add_argument("--min_occurrences", type=int, default=9)
    args = parser.parse_args(argv)

    if args.annotations:
        files = args.annotations
        out = args.out or os.path.join(os.path.dirname(files[0]), "ans2label.pkl")
    elif args.vqa_dir:
        files = [os.path.join(args.vqa_dir, n) for n in VQAV2_ANNOTATION_FILES]
        out = args.out or os.path.join(args.vqa_dir, "ans2label.pkl")
    else:
        parser.error("need a vqa_dir or --annotations")

    ans2label = write_vqa_labels(files, out, args.min_occurrences)
    print(f"Number of labels: {len(ans2label)} -> {out}")
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    raise SystemExit(main())
