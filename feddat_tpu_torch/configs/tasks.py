"""Task / client registry (copy of ``feddat_tpu/configs/tasks.py``).

Mirrors the reference's federated task configs
(``src/configs/task_configs_fed.py:39-282``) and client-set resolution
(``src/train/main.py:352-359``) as typed specs.  Hyperparameters (lr, wd,
adam eps, warmup) are carried per-task exactly as the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    """One client / task (reference dict schema: ``task_configs_fed.py:39-55``)."""

    task_key: str
    task_name: str
    data_dir: str
    images_source: str
    splits: Tuple[str, ...]
    num_labels: int = 100
    num_images: int = 1
    model_type: str = "classification"  # classification | multi-choice
    num_choices: int = 1
    num_epochs: int = 20
    lr: float = 1e-4
    weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    warmup_ratio: float = 0.1
    random_baseline_score: float = 0.0
    trainer: str = "vqa_cross"  # vqa_cross | vqa | nlvr2 | snli_ve | vcr


def _clove(group: str, letter: str) -> TaskSpec:
    return TaskSpec(
        task_key=f"clove_{group}_{letter}",
        task_name=f"clove_{group}_{letter}",
        data_dir=f"CLOVE/json/{group}",
        images_source="vgd",
        splits=("train", "val_small"),
    )


TASK_CONFIGS: Dict[str, TaskSpec] = {}

for _l in "abcdef":
    TASK_CONFIGS[f"clove_scene_{_l}"] = _clove("scene", _l)
for _l in "abcde":
    TASK_CONFIGS[f"clove_function_{_l}"] = _clove("function", _l)

TASK_CONFIGS["vizwiz"] = TaskSpec(
    task_key="vizwiz",
    task_name="vizwiz",
    data_dir="vizwiz",
    images_source="vizwiz",
    splits=("train", "val_small"),
)
TASK_CONFIGS["gqa"] = TaskSpec(
    task_key="gqa",
    task_name="gqa",
    data_dir="GQA",
    images_source="vg",
    splits=("train", "val_small"),
)
TASK_CONFIGS["abstract"] = TaskSpec(
    task_key="abstract",
    task_name="abstract",
    data_dir="vqa_abstract",
    images_source="abstract_image",
    splits=("train", "val_small"),
)
TASK_CONFIGS["toronto"] = TaskSpec(
    task_key="toronto",
    task_name="toronto",
    data_dir="torontoCOCO",
    images_source="toronto_image",
    splits=("train", "val"),
)
TASK_CONFIGS["art"] = TaskSpec(
    task_key="art",
    task_name="art",
    data_dir="albef/art",
    images_source="art_image",
    splits=("train", "val"),
)
# Legacy / non-federated tasks (reference: ``task_configs_fed.py:189-250``).
TASK_CONFIGS["vqa"] = TaskSpec(
    task_key="vqa",
    task_name="VQAv2",
    data_dir="vqav2/",
    images_source="ms-coco",
    splits=("train", "val"),
    num_labels=3129,
    num_epochs=10,
    trainer="vqa",
)
TASK_CONFIGS["nlvr2"] = TaskSpec(
    task_key="nlvr2",
    task_name="NLVRv2",
    data_dir="nlvr2/",
    images_source="ms-coco",
    splits=("train", "val"),
    num_labels=2,
    num_images=2,
    num_epochs=10,
    random_baseline_score=50.0,
    trainer="nlvr2",
)
TASK_CONFIGS["snli-ve"] = TaskSpec(
    task_key="snli-ve",
    task_name="SNLI-VE",
    data_dir="snli-ve/",
    images_source="flickr30k",
    splits=("train", "dev", "test"),
    num_labels=3,
    num_epochs=5,
    lr=5e-5,
    random_baseline_score=33.33,
    trainer="snli_ve",
)
TASK_CONFIGS["vcr"] = TaskSpec(
    task_key="vcr",
    task_name="VCR",
    data_dir="vcr/",
    images_source="vcr",
    splits=("train", "dev", "test"),
    num_labels=4,
    model_type="multi-choice",
    num_choices=4,
    num_epochs=10,
    random_baseline_score=25.0,
    trainer="vcr",
)


# Client sets (reference: ``src/train/main.py:352-359``).
CLIENT_SETS: Dict[str, Tuple[str, ...]] = {
    "scene": tuple(f"clove_scene_{l}" for l in "abcdef"),
    "function": tuple(f"clove_function_{l}" for l in "abcde"),
    "domain": ("art", "abstract", "vizwiz", "toronto", "gqa"),
}


def resolve_clients(spec) -> Tuple[str, ...]:
    """Map a client-set keyword or explicit tuple of task keys to task keys."""
    if isinstance(spec, str):
        if spec in CLIENT_SETS:
            return CLIENT_SETS[spec]
        if spec in TASK_CONFIGS:
            return (spec,)
        raise KeyError(f"Unknown client set or task key: {spec!r}")
    keys = tuple(spec)
    unknown = [k for k in keys if k not in TASK_CONFIGS]
    if unknown:
        raise KeyError(
            f"Unknown task key(s) {unknown!r}; known: {sorted(TASK_CONFIGS)}"
        )
    return keys


def register_task(spec: TaskSpec, overwrite: bool = False) -> None:
    """Register a custom task/client at runtime (used by tests and users)."""
    if spec.task_key in TASK_CONFIGS and not overwrite:
        raise KeyError(f"Task {spec.task_key!r} already registered")
    TASK_CONFIGS[spec.task_key] = spec
