"""Carry a JAX-package parameter tree into the port's modules.

``vilt_from_flax`` maps the flax tree of ``feddat_tpu``'s
``ViltContinualLearner`` (nested dicts of numpy arrays) onto the state_dict
of ``feddat_tpu_torch.models.vilt.ViltContinualLearner``.  It is the inverse
of ``feddat_tpu/utils/checkpoint_convert.py``'s ``_linear``/``_stack``:

* flax ``Dense`` ``kernel [in, out]`` -> ``nn.Linear.weight [out, in]``;
* the ``nn.scan`` stack ``vilt/layers/layer/...`` with a leading ``[L]``
  axis -> ``vilt.layers.<i>....`` for each of the L layers;
* the NHWC conv ``kernel [kh, kw, in, out]`` -> ``Conv2d.weight [out, in, kh, kw]``;
* ``Embed.embedding`` and LayerNorm ``scale`` -> ``.weight``; ``bias`` as is;
* ``cls_token`` and ``position_embeddings`` as they are.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_STACK = ("vilt", "layers", "layer")


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _leaf(path: Tuple[str, ...], value: np.ndarray) -> Tuple[str, np.ndarray]:
    parent, last = ".".join(path[:-1]), path[-1]
    if last == "kernel":
        if value.ndim == 4:  # conv HWIO -> OIHW
            return f"{parent}.weight", value.transpose(3, 2, 0, 1)
        return f"{parent}.weight", value.T
    if last in ("scale", "embedding"):
        return f"{parent}.weight", value
    return ".".join(path), value


def vilt_from_flax(params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax param tree (numpy leaves) -> state_dict (fp32 CPU tensors)."""
    out: Dict[str, torch.Tensor] = {}

    def put(path, value):
        key, arr = _leaf(path, np.asarray(value, np.float32))
        if key in out:
            raise ValueError(f"two flax leaves map to {key!r}")
        out[key] = torch.tensor(arr)

    for path, value in _flatten(params_np):
        if path[:3] == _STACK:
            for i in range(np.shape(value)[0]):
                put(("vilt", "layers", str(i)) + path[3:], np.asarray(value)[i])
        else:
            put(path, value)
    return out
