"""Batch inference surface (counterpart of ``feddat_tpu/serving.py``).

* :class:`ViltVqaPredictor` (lines 104-252): classification VQA.  Host
  preprocessing (``vilt_resized_u8`` + ``pack_u8_canvas`` + WordPiece),
  padding to the smallest batch bucket that fits, one continual-learner
  forward under ``torch.inference_mode()``, an fp32 softmax and a top-k.
* :class:`AlbefVqaPredictor` (lines 255-390): answer-ranking VQA, ALBEF's
  two-stage ``rank_answer`` over an answer bank kept on the device.

Both run their device work (:meth:`ViltVqaPredictor.forward`'s forward and
softmax, :meth:`AlbefVqaPredictor.rank`'s ``rank_answer``) as a
:class:`~feddat_tpu_torch.train.compiled.Compiled` function: one CUDA graph per
batch bucket on the card, as JAX jits its predictors (serving.py:171, :300).
``from_checkpoint`` waits for the checkpoint port (ROADMAP Queue 1, item 5).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from feddat_tpu_torch.data.albef_pipeline import encode_answer_bank
from feddat_tpu_torch.data.images import albef_resized_u8, pack_u8_canvas, vilt_resized_u8
from feddat_tpu_torch.data.text import pre_question
from feddat_tpu_torch.device import DeviceLike, resolve_device
from feddat_tpu_torch.train.compiled import Compiled
from feddat_tpu_torch.utils.param_bridge import albef_from_flax, vilt_from_flax


def _pad_batch(arrs: Dict[str, np.ndarray], batch_size: int) -> Tuple[Dict[str, np.ndarray], int]:
    """Zero-pad every leading dim to ``batch_size``; returns (batch, n_real)."""
    n = next(iter(arrs.values())).shape[0]
    if n > batch_size:
        raise ValueError(f"{n} examples > batch size {batch_size}")
    out = {}
    for k, v in arrs.items():
        pad = batch_size - n
        out[k] = np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)]) if pad else v
    return out, n


def _normalize_buckets(batch_buckets: Optional[Sequence[int]], batch_size: int) -> Tuple[int, ...]:
    """Ascending unique bucket sizes, always including ``batch_size``."""
    buckets = sorted(set(batch_buckets or ()) | {batch_size})
    if any(b <= 0 for b in buckets):
        raise ValueError(f"batch buckets must be positive: {buckets}")
    return tuple(buckets)


def _bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket that fits ``n`` examples."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _load_params(model: torch.nn.Module, params_or_state, bridge=vilt_from_flax) -> None:
    """None keeps the model's weights; a torch state_dict loads as is; a
    JAX-package param tree (nested dicts of arrays) goes through ``bridge``
    (``utils/param_bridge.py``)."""
    if params_or_state is None:
        return
    state = params_or_state
    if any(isinstance(v, Mapping) for v in state.values()):
        state = bridge(state)
    model.load_state_dict(state, strict=True)


def _on_device(batch: Dict[str, np.ndarray], device: torch.device):
    """The prologue of a predictor's compiled call: numpy batch -> tensors on
    ``device``."""
    return {"batch": {k: torch.from_numpy(v).to(device) for k, v in batch.items()}}, (), None


def _open(img):
    if hasattr(img, "convert"):
        return img
    from PIL import Image

    return Image.open(img)


class ViltVqaPredictor:
    """Serving wrapper for a ViLT continual learner.

    ``label2ans`` maps class index -> answer string; ``adapter_mode`` follows
    eval semantics ('ensemble' for DAT, a named adapter, or 'none');
    ``batch_buckets`` are extra batch sizes so a small request runs at the
    smallest one that fits.  The model moves to ``device`` (default CUDA)."""

    def __init__(
        self,
        model: torch.nn.Module,
        params_or_state,
        task_key: str,
        tokenizer,
        label2ans: Sequence[str],
        batch_size: int = 16,
        canvas: Tuple[int, int] = (384, 640),
        max_text_len: int = 40,
        adapter_mode: str = "ensemble",
        batch_buckets: Optional[Sequence[int]] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        _load_params(self.model, params_or_state)
        self.task_key = task_key
        self.tokenizer = tokenizer
        self.label2ans = list(label2ans)
        self.batch_size = batch_size
        self.buckets = _normalize_buckets(batch_buckets, batch_size)
        self.canvas = tuple(canvas)
        self.max_text_len = max_text_len
        self.adapter_mode = adapter_mode
        self._forward = Compiled(self._probs, lambda batch: _on_device(batch, self.device),
                                 name="vilt_forward")

    def _probs(self, inp, gens):
        with torch.inference_mode():
            _, logits = self.model(self.task_key, inp["batch"], adapter_mode=self.adapter_mode,
                                   deterministic=True)
            return torch.softmax(logits.to(torch.float32), dim=-1)

    def _preprocess(self, images, questions) -> Dict[str, np.ndarray]:
        u8s = [vilt_resized_u8(_open(img), self.canvas) for img in images]
        pixels, dims = pack_u8_canvas(u8s, self.canvas)
        ids, mask = self.tokenizer.batch_encode(list(questions), self.max_text_len)
        return {
            "input_ids": ids,
            "attention_mask": mask,
            "pixel_values": pixels,  # u8: the model normalises on the device
            "pixel_mask": dims,      # compact [B, 2] rectangle mask
        }

    def forward(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        """Padded numpy batch -> class probabilities [B, num_labels] (fp32)."""
        return self._forward(batch).cpu().numpy()

    def predict(self, images: Sequence[Any], questions: Sequence[str],
                top_k: int = 5) -> List[List[Tuple[str, float]]]:
        """-> per example, top-k (answer, probability), descending."""
        if len(images) != len(questions):
            raise ValueError(f"{len(images)} images for {len(questions)} questions")
        results: List[List[Tuple[str, float]]] = []
        for s in range(0, len(images), self.batch_size):
            chunk_imgs = images[s : s + self.batch_size]
            chunk_qs = questions[s : s + self.batch_size]
            bucket = _bucket_for(len(chunk_imgs), self.buckets)
            batch, n = _pad_batch(self._preprocess(chunk_imgs, chunk_qs), bucket)
            probs = self.forward(batch)[:n]
            order = np.argsort(-probs, axis=-1)[:, :top_k]
            for i in range(n):
                results.append([(self.label2ans[j], float(probs[i, j])) for j in order[i]])
        return results


class AlbefVqaPredictor:
    """Serving wrapper for ALBEF: two-stage answer ranking over a fixed
    answer list (``AlbefModel.rank_answer``).

    The tokenised answer bank lives on ``device`` (default CUDA) beside the
    model; ``k`` is capped by the bank's size, and ``predict``'s ``top_k``
    by ``k``.  ``batch_buckets`` as in :class:`ViltVqaPredictor`."""

    def __init__(
        self,
        model: torch.nn.Module,
        params_or_state,
        tokenizer,
        answer_list: Sequence[str],
        batch_size: int = 16,
        k: int = 64,
        max_question_len: int = 25,
        max_answer_len: int = 10,
        adapter_mode: str = "ensemble",
        pad_token_id: int = 0,
        batch_buckets: Optional[Sequence[int]] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        _load_params(self.model, params_or_state, albef_from_flax)
        self.tokenizer = tokenizer
        self.answer_list = list(answer_list)
        self.batch_size = batch_size
        self.buckets = _normalize_buckets(batch_buckets, batch_size)
        self.max_question_len = max_question_len
        self.image_size = self.model.cfg.image_res
        self.adapter_mode = adapter_mode
        self.pad_token_id = pad_token_id
        ids, mask = encode_answer_bank(tokenizer, self.answer_list, max_answer_len)
        self.bank = tuple(torch.from_numpy(a).to(self.device) for a in (ids, mask))
        self.k = min(k, len(self.answer_list))
        self._rank = Compiled(self._rank_body, self._rank_prologue, name="albef_rank")

    def _rank_prologue(self, batch):
        inputs, seeds, host = _on_device(batch, self.device)
        return {**inputs, "bank": self.bank}, seeds, host

    def _rank_body(self, inp, gens):
        with torch.inference_mode():
            return self.model.rank_answer(inp["batch"], *inp["bank"], self.k, self.adapter_mode,
                                          self.pad_token_id)

    @classmethod
    def from_checkpoint(cls, *args, **kwargs):
        raise NotImplementedError("serving from a checkpoint is not ported yet "
                                  "(ROADMAP Queue 1, item 5: checkpoints)")

    def _preprocess(self, images, questions) -> Dict[str, np.ndarray]:
        pixels = np.stack([albef_resized_u8(_open(img), self.image_size) for img in images])
        ids, mask = self.tokenizer.batch_encode([pre_question(q, 50) for q in questions],
                                                self.max_question_len)
        return {
            "pixel_values": pixels,  # u8: the ViT CLIP-normalises on the device
            "question_ids": ids,
            "question_mask": mask,
        }

    def rank(self, batch: Dict[str, np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
        """Padded numpy batch -> (answer indices [B, k], probabilities [B, k]),
        descending."""
        ids, probs = self._rank(batch)
        return ids.cpu().numpy(), probs.cpu().numpy()

    def predict(self, images: Sequence[Any], questions: Sequence[str],
                top_k: int = 5) -> List[List[Tuple[str, float]]]:
        """-> per example, top-k (answer, rerank probability), descending."""
        if len(images) != len(questions):
            raise ValueError(f"{len(images)} images for {len(questions)} questions")
        if top_k > self.k:
            raise ValueError(f"top_k={top_k} exceeds the rerank width k={self.k}; "
                             "construct the predictor with a larger k")
        results: List[List[Tuple[str, float]]] = []
        for s in range(0, len(images), self.batch_size):
            chunk = self._preprocess(images[s : s + self.batch_size],
                                     questions[s : s + self.batch_size])
            bucket = _bucket_for(chunk["pixel_values"].shape[0], self.buckets)
            batch, n = _pad_batch(chunk, bucket)
            ids, probs = self.rank(batch)
            for i in range(n):
                results.append([(self.answer_list[int(j)], float(p))
                                 for j, p in zip(ids[i, :top_k], probs[i, :top_k])])
        return results
