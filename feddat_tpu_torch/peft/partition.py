"""Structural parameter partitioning on state_dict names.

Counterpart of ``feddat_tpu/peft/partition.py``: every parameter name gets a
*role*, and the PEFT mode maps roles to {trainable, communicated, personal}
sets (the reference's ``requires_grad`` masks, ``comm_state_dict_names`` and
``personal_params`` name matching, ``src/train/main.py:125-250, 440-450``).
Parameters are flat dicts ``{state_dict name: tensor}``; the roles follow
``_role_of_path`` (partition.py:47-78) with the same precedence.

Roles: ``backbone``, ``shared`` (adapter_1 under DAT, the one adapter under
plain adapter mode), ``local`` (adapter_0), ``teacher`` (adapter_2), ``head``
(task heads), and the baseline partitions ``norm``/``norm_bias``/``bias``/
``lora``/``prompt``.
"""

from __future__ import annotations

from typing import Any, Dict, FrozenSet, Tuple

from feddat_tpu_torch.configs.core import PEFTMode

ROLE_BACKBONE = "backbone"
ROLE_SHARED = "shared"
ROLE_LOCAL = "local"
ROLE_TEACHER = "teacher"
ROLE_HEAD = "head"
ROLE_NORM = "norm"
ROLE_NORM_BIAS = "norm_bias"
ROLE_BIAS = "bias"
ROLE_LORA = "lora"
ROLE_PROMPT = "prompt"

Params = Dict[str, Any]


def _role_of_path(name: str) -> str:
    """Classify one parameter name (adapter/lora/prompt/head tags beat the
    generic norm/bias fallbacks)."""
    parts = name.split(".")
    if "task_" in name or "cls" in parts:
        return ROLE_HEAD
    if "adapter_1" in name:
        return ROLE_SHARED
    if "adapter_0" in name:
        return ROLE_LOCAL
    if "adapter_2" in name:
        return ROLE_TEACHER
    if "adapter" in name:
        return ROLE_SHARED
    if "lora_" in name:
        return ROLE_LORA
    if "prompt" in name:
        return ROLE_PROMPT
    if "norm" in name:
        return ROLE_NORM_BIAS if parts[-1] == "bias" else ROLE_NORM
    if parts[-1] == "bias":
        return ROLE_BIAS
    return ROLE_BACKBONE


def label_params(params: Params) -> Dict[str, str]:
    """name -> role."""
    return {name: _role_of_path(name) for name in params}


def trainable_roles(mode: PEFTMode, num_layers_frozen: int = 0) -> FrozenSet[str]:
    """Which roles receive gradients (reference ``main.py:132-250``); heads always."""
    base = {ROLE_HEAD}
    if mode == PEFTMode.FULL:
        return frozenset(base | {ROLE_BACKBONE, ROLE_SHARED, ROLE_LOCAL, ROLE_NORM,
                                 ROLE_NORM_BIAS, ROLE_BIAS, ROLE_LORA, ROLE_PROMPT})
    if mode == PEFTMode.ADAPTER:
        return frozenset(base | {ROLE_SHARED})
    if mode == PEFTMode.DAT:
        return frozenset(base | {ROLE_SHARED, ROLE_LOCAL})
    if mode == PEFTMode.NORM:
        return frozenset(base | {ROLE_NORM, ROLE_NORM_BIAS})
    if mode == PEFTMode.BIAS:
        return frozenset(base | {ROLE_BIAS, ROLE_NORM_BIAS})
    if mode == PEFTMode.LORA:
        return frozenset(base | {ROLE_LORA})
    if mode == PEFTMode.PROMPT:
        return frozenset(base | {ROLE_PROMPT})
    if mode in (PEFTMode.NONE, PEFTMode.FREEZE_ENCODER):
        return frozenset(base)
    if mode == PEFTMode.FREEZE_BOTTOM_K:
        return frozenset(base | {ROLE_BACKBONE, ROLE_NORM, ROLE_NORM_BIAS, ROLE_BIAS})
    raise ValueError(f"unknown mode {mode}")


def comm_roles(mode: PEFTMode) -> FrozenSet[str]:
    """Roles in the FedAvg-communicated subset (``main.py:132-245``)."""
    if mode == PEFTMode.FULL:
        return frozenset({ROLE_BACKBONE, ROLE_SHARED, ROLE_LOCAL, ROLE_TEACHER, ROLE_NORM,
                          ROLE_NORM_BIAS, ROLE_BIAS})
    if mode in (PEFTMode.ADAPTER, PEFTMode.DAT):
        return frozenset({ROLE_SHARED})
    if mode == PEFTMode.NORM:
        return frozenset({ROLE_NORM, ROLE_NORM_BIAS})
    if mode == PEFTMode.BIAS:
        return frozenset({ROLE_BIAS, ROLE_NORM_BIAS})
    if mode == PEFTMode.LORA:
        return frozenset({ROLE_LORA})
    if mode == PEFTMode.PROMPT:
        return frozenset({ROLE_PROMPT})
    return frozenset()


def personal_roles(mode: PEFTMode) -> FrozenSet[str]:
    """Client-personal partitions: heads always; plus the local adapter and
    the teacher under DAT (``main.py:127-130, 154``)."""
    if mode == PEFTMode.DAT:
        return frozenset({ROLE_HEAD, ROLE_LOCAL, ROLE_TEACHER})
    return frozenset({ROLE_HEAD})


def split_by_roles(params: Params, labels: Dict[str, str],
                   roles: FrozenSet[str]) -> Tuple[Params, Params]:
    """-> (params whose role is in ``roles``, the rest)."""
    inside = {k: v for k, v in params.items() if labels[k] in roles}
    outside = {k: v for k, v in params.items() if labels[k] not in roles}
    return inside, outside


def merge(*trees: Params) -> Params:
    """Reassemble dicts produced by ``split_by_roles`` (disjoint names)."""
    out: Params = {}
    for t in trees:
        out.update(t)
    return out


def teacher_refresh(params: Params) -> Params:
    """Copy ``adapter_1`` into ``adapter_2`` (the DAT teacher refresh at the
    start of each client's local training, ``task_trainer.py:36-45``)."""
    out = dict(params)
    for name, value in params.items():
        if "adapter_1" in name:
            target = name.replace("adapter_1", "adapter_2")
            if target in params:
                out[target] = value
    return out


def count_params(params: Params) -> int:
    return sum(int(v.numel()) for v in params.values())


def param_budget(params: Params, mode: PEFTMode) -> Dict[str, Any]:
    """Total / trainable / communicated / personal counts and trainable %
    (reference ``src/train/main.py:371-374``)."""
    labels = label_params(params)
    total = count_params(params)
    n_train = count_params(split_by_roles(params, labels, trainable_roles(mode))[0])
    return {
        "total": total,
        "trainable": n_train,
        "communicated": count_params(split_by_roles(params, labels, comm_roles(mode))[0]),
        "personal": count_params(split_by_roles(params, labels, personal_roles(mode))[0]),
        "trainable_pct": 100.0 * n_train / max(total, 1),
    }
