"""Carry a JAX-package parameter tree into the port's modules.

``vilt_from_flax``, ``viltbert_from_flax`` and ``albef_from_flax`` map the
flax trees of ``feddat_tpu``'s ``ViltContinualLearner`` (and the
``vilt_clf`` classifiers, whose encoder is ``vilt`` too),
``ViltBertContinualLearner`` and ``AlbefModel`` (with its visual prompt
``prompt_vis``), and ``xbert_mlm_from_flax`` that of ``XBertMaskedLM``
(nested dicts of numpy arrays), onto the state_dicts of the port's twins.  They are the inverse
of ``feddat_tpu/utils/checkpoint_convert.py``'s ``_linear``/``_stack``:

* flax ``Dense`` ``kernel [in, out]`` -> ``nn.Linear.weight [out, in]``;
* an ``nn.scan`` stack ``<prefix>/<cell>/...`` with a leading ``[L]`` axis
  -> ``<prefix>.<i>....`` for each of the L layers (ViLT's ``vilt/layers/
  layer``; ViLT-BERT's ``text_bert/encoder/text_layers/layer``; ALBEF's ViT
  blocks, text and fusion layers and decoder layers; the masked-LM
  encoder's text and fusion layers);
* the NHWC conv ``kernel [kh, kw, in, out]`` -> ``Conv2d.weight [out, in, kh, kw]``;
* ``Embed.embedding`` and LayerNorm ``scale`` -> ``.weight``; ``bias`` as is;
* ``cls_token`` and ``position_embeddings`` as they are.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

VILT_STACKS = (("vilt", "layers", "layer"),)
ALBEF_STACKS = (
    ("visual_encoder", "blocks", "block"),
    ("text_encoder", "encoder", "text_layers", "layer"),
    ("text_encoder", "encoder", "fusion_layers", "layer"),
    ("text_decoder", "bert", "encoder", "fusion_layers", "layer"),
)


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


def _from_flax(params_np: Mapping[str, Any], stacks) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}

    def put(path, value):
        key, arr = _leaf(path, np.asarray(value, np.float32))
        if key in out:
            raise ValueError(f"two flax leaves map to {key!r}")
        out[key] = torch.tensor(arr)

    for path, value in _flatten(params_np):
        stack = next((st for st in stacks if path[:len(st)] == st), None)
        if stack is None:
            put(path, value)
            continue
        for i in range(np.shape(value)[0]):
            put(stack[:-1] + (str(i),) + path[len(stack):], np.asarray(value)[i])
    return out


def vilt_from_flax(params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """ViLT flax param tree (numpy leaves) -> state_dict (fp32 CPU tensors);
    also the ``vilt_clf`` classifiers' trees (``vilt`` + ``task_clf``)."""
    return _from_flax(params_np, VILT_STACKS)


VILTBERT_STACKS = VILT_STACKS + (("text_bert", "encoder", "text_layers", "layer"),)


def viltbert_from_flax(params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """ViLT-BERT flax param tree (numpy leaves) -> state_dict (fp32 CPU
    tensors): the ViLT half as :func:`vilt_from_flax` maps it (it has no
    word table), the text BERT as an ``XBertModel`` without fusion layers."""
    return _from_flax(params_np, VILTBERT_STACKS)


XBERT_MLM_STACKS = (
    ("bert", "encoder", "text_layers", "layer"),
    ("bert", "encoder", "fusion_layers", "layer"),
)


def xbert_mlm_from_flax(params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``XBertMaskedLM`` flax param tree (numpy leaves) -> state_dict (fp32
    CPU tensors); ``cls/decoder/bias`` is the tied projection's bias."""
    return _from_flax(params_np, XBERT_MLM_STACKS)


def albef_from_flax(params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """ALBEF flax param tree (numpy leaves) -> state_dict (fp32 CPU tensors);
    the decoder's ``cls/decoder/bias`` is the tied projection's bias."""
    return _from_flax(params_np, ALBEF_STACKS)
