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

``from_checkpoint`` (serving.py:181-213, :310-339) rebuilds a predictor from a
training run's checkpoint directory: the run recipe (``meta.json``) and the
latest round's parameters with the client's personal partition merged over
the server's, as the engine evaluates them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from feddat_tpu_torch.data.albef_pipeline import encode_answer_bank
from feddat_tpu_torch.data.images import albef_resized_u8, pack_u8_canvas, vilt_resized_u8
from feddat_tpu_torch.data.text import pre_question
from feddat_tpu_torch.device import DeviceLike, resolve_device
from feddat_tpu_torch.federated.spmd import FED_HEAD_KEY  # the SPMD clients' one head
from feddat_tpu_torch.peft.partition import merge
from feddat_tpu_torch.train.compiled import Compiled
from feddat_tpu_torch.utils.checkpointing import load_meta, restore_federated_state
from feddat_tpu_torch.utils.param_bridge import albef_from_flax, vilt_from_flax



def _load_checkpoint_recipe(checkpoint_dir: str, task_key: Optional[str], device: torch.device):
    """-> (meta, resolved task_key, personalised params on ``device``, default
    adapter_mode), from the run recipe (``meta.json``) and the latest round.
    Both engines' layouts: the sequential store (``personal[task_key]``) and
    the SPMD engine's stacked client bank (row ``tasks.index(task_key)``)."""
    meta = load_meta(checkpoint_dir)
    if meta is None:
        raise FileNotFoundError(
            f"no meta.json in {checkpoint_dir!r} — serving needs the run "
            "recipe the CLI writes next to its round checkpoints"
        )
    if meta.get("smoke"):
        raise ValueError(
            "this checkpoint was written by a --smoke run (tiny dev model); "
            "smoke models are not reconstructible for serving"
        )
    if task_key is None:
        if len(meta["tasks"]) != 1:
            raise ValueError(
                f"checkpoint holds {len(meta['tasks'])} clients "
                f"({meta['tasks']}); pass task_key="
            )
        task_key = meta["tasks"][0]
    if task_key not in meta["tasks"]:
        raise KeyError(f"task {task_key!r} not in checkpoint tasks {meta['tasks']}")
    restored = restore_federated_state(checkpoint_dir, device=device)
    if restored is None:
        raise FileNotFoundError(f"no round checkpoints in {checkpoint_dir!r}")
    _, server, personal, _ = restored
    if "stacked_clients" in personal:  # the SPMD engine's [C]-leading client bank
        i = meta["tasks"].index(task_key)
        params = merge(server, {k: v[i] for k, v in personal["stacked_clients"].items()})
    else:
        params = merge(server, personal[task_key])
    adapter_mode = {"dat": "ensemble", "adapter": "adapter"}.get(meta["optimizer_mode"], "none")
    return meta, task_key, params, adapter_mode


def _model_from_meta(meta, device: torch.device):
    """Rebuild the training-time model from the checkpoint recipe, with
    ``create_model``'s defaults (``attn_impl="auto"``) -> (model, config); its
    weights are left uninitialised: the predictor runs it on the
    checkpoint's parameters."""
    from feddat_tpu_torch.configs.core import PEFTMode
    from feddat_tpu_torch.models import create_model
    from feddat_tpu_torch.models.vilt import TaskHeadSpec

    if meta["engine"] == "spmd":
        heads = {FED_HEAD_KEY: TaskHeadSpec(**next(iter(meta["heads"].values())))}
    else:
        heads = {k: TaskHeadSpec(**v) for k, v in meta["heads"].items()}
    return create_model(
        meta["encoder_name"], heads, PEFTMode(meta["optimizer_mode"]),
        meta["adapter_reduction_factor"], meta["dtype"],
        image_size=tuple(meta["image_size"]) if meta.get("image_size") else None,
        attention_logits_dtype=meta.get("attention_logits_dtype") or "float32",
        device=device, seed=None,
    )


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

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str, tokenizer, label2ans: Sequence[str],
                        task_key: Optional[str] = None, model: Optional[torch.nn.Module] = None,
                        adapter_mode: Optional[str] = None, device: DeviceLike = None,
                        **kw) -> "ViltVqaPredictor":
        """Train -> serve in one call: the model rebuilt from the run recipe
        (``meta.json``) with the latest round's personalised parameters of
        ``task_key`` (which may be omitted when the run had one client).
        ``model`` replaces the rebuilt one (the caller guarantees it matches
        the checkpoint, e.g. a model on the kernel route);
        ``adapter_mode`` defaults to the trained PEFT mode's eval mode (DAT
        -> 'ensemble')."""
        device = resolve_device(device)
        meta, task_key, params, default_mode = _load_checkpoint_recipe(checkpoint_dir, task_key,
                                                                       device)
        if model is None:
            model, _ = _model_from_meta(meta, device)
        head_key = FED_HEAD_KEY if meta["engine"] == "spmd" else task_key
        return cls(model, params, head_key, tokenizer, label2ans,
                   adapter_mode=adapter_mode or default_mode, device=device, **kw)

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
    def from_checkpoint(cls, checkpoint_dir: str, tokenizer, task_key: Optional[str] = None,
                        answer_list: Optional[Sequence[str]] = None,
                        model: Optional[torch.nn.Module] = None,
                        adapter_mode: Optional[str] = None, device: DeviceLike = None,
                        **kw) -> "AlbefVqaPredictor":
        """Train -> serve for ALBEF (see :meth:`ViltVqaPredictor.from_checkpoint`);
        ``answer_list`` defaults to the task's trained answer bank in the
        run recipe."""
        device = resolve_device(device)
        meta, task_key, params, default_mode = _load_checkpoint_recipe(checkpoint_dir, task_key,
                                                                       device)
        if answer_list is None:
            lists = meta.get("answer_lists") or {}
            if task_key not in lists:
                raise ValueError("checkpoint recipe carries no answer list for "
                                 f"{task_key!r}; pass answer_list=")
            answer_list = lists[task_key]
        if model is None:
            model, _ = _model_from_meta(meta, device)
        return cls(model, params, tokenizer, answer_list,
                   adapter_mode=adapter_mode or default_mode, device=device, **kw)

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
