"""ALBEF host pipeline: dense answer banks with static shapes (counterpart of
``feddat_tpu/data/albef_pipeline.py``).

The reference's ragged ALBEF collators (``vqa_dataset_crossvqa.py:443-471``:
flattened answers and per-question counts) become a dense ``[B, A, La]``
answer bank padded with zero weights: the same weighted loss, static shapes.
Train answer weights are occurrences / number of annotations
(``vqa_dataset_crossvqa.py:355-375``); eval items carry the ground-truth label
set padded to ``gt_pad``.  Answers are encoded once with the standard
``[CLS] ... [SEP]`` framing.  :func:`encode_answer_bank` also serves
rank-answer serving and eval.  The batches are bitwise the JAX package's on
the same examples; the u8 cache is normalised by the native host core when it
is available (``feddat_tpu_torch/native``), else by numpy, to the same bits.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from feddat_tpu_torch.data.datasets import VQAExample
from feddat_tpu_torch.data.images import CLIP_MEAN, CLIP_STD, albef_resized_u8, process_albef_image
from feddat_tpu_torch.data.pipeline import iter_eval_chunks, shard_rows
from feddat_tpu_torch.data.text import pre_question


def encode_answer_bank(tokenizer, answers: Sequence[str], max_len: int):
    """answer list -> ([N, La] ids, [N, La] mask), CLS-prefixed."""
    return tokenizer.batch_encode(list(answers), max_len)


class AlbefVQAPipeline:
    """Train/eval batches for the ALBEF path."""

    def __init__(
        self,
        examples: Sequence[VQAExample],
        backend,
        tokenizer,
        answer_list: Sequence[str],
        image_size: int = 384,
        max_question_len: int = 25,
        max_answer_len: int = 10,
        max_answers_per_q: int = 10,
        gt_pad: int = 10,
        batch_size: int = 8,
        seed: int = 0,
        num_workers: int = 8,
        max_ques_words_train: int = 30,
        max_ques_words_eval: int = 50,
        eval_examples: Optional[Sequence[VQAExample]] = None,
        cache_images: bool = False,
        cache_budget_bytes: int = 8 << 30,
        pixels_u8: bool = False,
        val_batch_size: Optional[int] = None,
    ):
        self.examples = list(examples)
        # separate eval split (reference builds distinct loaders); falls back
        # to the train examples when absent (tests/dev)
        self.eval_examples = list(eval_examples) if eval_examples is not None else self.examples
        self.task_key = None
        self.backend = backend
        self.tokenizer = tokenizer
        self.answer_list = list(answer_list)
        self.answer_ids, self.answer_mask = encode_answer_bank(
            tokenizer, self.answer_list, max_answer_len
        )
        self.image_size = image_size
        self.max_question_len = max_question_len
        self.max_answer_len = max_answer_len
        self.max_answers_per_q = max_answers_per_q
        self.gt_pad = gt_pad
        self.batch_size = batch_size
        # reference --val_batch_size feeds the eval loaders
        # (``vqa_dataset_crossvqa.py:598``); defaults to batch_size
        self.val_batch_size = val_batch_size or batch_size
        self.seed = seed
        self.max_ques_words_train = max_ques_words_train
        self.max_ques_words_eval = max_ques_words_eval
        self.num_workers = num_workers
        self.pool = ThreadPoolExecutor(num_workers) if num_workers > 0 else None
        # see ViltVQAPipeline: decode+resize cached as uint8, normalised per
        # epoch by the native core (numpy without it); pixels_u8 ships raw
        # uint8 (the model CLIP-normalises on the device)
        self.pixels_u8 = pixels_u8
        self._cache: Optional[Dict] = {} if cache_images else None
        self._cache_left = cache_budget_bytes
        self._cache_lock = threading.Lock()
        self._native_finalize = None
        if cache_images:
            from feddat_tpu_torch import native

            if native.available():
                self._native_finalize = native.finalize_canvas_batch

    @property
    def num_train_examples(self) -> int:
        return len(self.examples)

    @property
    def num_eval_examples(self) -> int:
        return len(self.eval_examples)

    @property
    def steps_per_epoch(self) -> int:
        return len(self.examples) // self.batch_size

    def _load_u8(self, ex: VQAExample) -> np.ndarray:
        if self._cache is not None:
            cached = self._cache.get(ex.image_id)
            if cached is not None:
                return cached
        arr = albef_resized_u8(self.backend.load(ex.image_id), self.image_size)
        if self._cache is not None:
            # atomic check-then-insert: see ViltVQAPipeline._load_u8
            with self._cache_lock:
                if ex.image_id not in self._cache and arr.nbytes <= self._cache_left:
                    self._cache[ex.image_id] = arr
                    self._cache_left -= arr.nbytes
        return arr

    def _images(self, batch_ex: List[VQAExample]) -> np.ndarray:
        if self.pixels_u8:
            if self.pool is not None:
                return np.stack(list(self.pool.map(self._load_u8, batch_ex)))
            return np.stack([self._load_u8(e) for e in batch_ex])
        if self._cache is not None:
            if self.pool is not None:
                u8s = list(self.pool.map(self._load_u8, batch_ex))
            else:
                u8s = [self._load_u8(e) for e in batch_ex]
            if self._native_finalize is not None:
                pixels, _ = self._native_finalize(
                    u8s, (self.image_size, self.image_size), CLIP_MEAN.tolist(), CLIP_STD.tolist(),
                    num_threads=max(1, self.num_workers), with_mask=False)
                return pixels
            return np.stack(
                [(a.astype(np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD for a in u8s]
            )

        def load(ex):
            return process_albef_image(self.backend.load(ex.image_id), self.image_size)

        if self.pool is not None:
            return np.stack(list(self.pool.map(load, batch_ex)))
        return np.stack([load(e) for e in batch_ex])

    def _answers_for(self, ex: VQAExample) -> Tuple[List[str], List[float]]:
        """Per-question answer weights = occurrences / total annotations
        (``vqa_dataset_crossvqa.py:361-367``).

        Path-exact with the reference: pickle-ingested examples keep raw
        (possibly duplicated) answer lists, so the ``+=`` accumulation
        reproduces count-weighted weights; raw-JSON-built examples are
        already deduplicated BY THE REFERENCE's build path too
        (``vqa_dataset_crossvqa.py:216-236`` stores distinct answers), so
        uniform weights there match it as well."""
        weight: Dict[str, float] = defaultdict(float)
        for ans in ex.answers:
            weight[ans] += 1.0 / max(1, len(ex.answers))
        return list(weight.keys()), list(weight.values())

    def train_batches(self, epoch: int = 0,
                      shard: Tuple[int, int] = (0, 1)) -> Iterator[Dict[str, np.ndarray]]:
        """``shard = (d, D)``: only rows ``shard_rows`` of each batch."""
        rows = shard_rows(self.batch_size, shard)
        rng = np.random.RandomState(self.seed * 1000 + epoch)
        idx = rng.permutation(len(self.examples))
        A, La = self.max_answers_per_q, self.max_answer_len
        for s in range(self.steps_per_epoch):
            sel = [self.examples[i] for i in idx[s * self.batch_size : (s + 1) * self.batch_size][rows]]
            B = len(sel)
            q_ids, q_mask = self.tokenizer.batch_encode(
                [pre_question(e.question, self.max_ques_words_train) for e in sel],
                self.max_question_len,
            )
            ans_ids = np.zeros((B, A, La), np.int32)
            ans_mask = np.zeros((B, A, La), np.int32)
            weights = np.zeros((B, A), np.float32)
            for i, ex in enumerate(sel):
                answers, ws = self._answers_for(ex)
                answers, ws = answers[:A], ws[:A]
                ids, mask = self.tokenizer.batch_encode(answers, La)
                ans_ids[i, : len(answers)] = ids
                ans_mask[i, : len(answers)] = mask
                weights[i, : len(ws)] = ws
            yield {
                "pixel_values": self._images(sel),
                "question_ids": q_ids,
                "question_mask": q_mask,
                "answer_ids": ans_ids,
                "answer_mask": ans_mask,
                "answer_weights": weights,
            }

    def eval_batches(self, shard: Tuple[int, int] = (0, 1)) -> Iterator[Dict[str, np.ndarray]]:
        rows = shard_rows(self.val_batch_size, shard)
        for chunk, valid in iter_eval_chunks(self.eval_examples, self.val_batch_size):
            chunk, valid = chunk[rows], valid[rows]
            q_ids, q_mask = self.tokenizer.batch_encode(
                [pre_question(e.question, self.max_ques_words_eval) for e in chunk],
                self.max_question_len,
            )
            gts = np.full((len(chunk), self.gt_pad), -1, np.int64)
            for i, ex in enumerate(chunk):
                labels = ex.labels[: self.gt_pad]
                gts[i, : len(labels)] = labels
            yield {
                "pixel_values": self._images(chunk),
                "question_ids": q_ids,
                "question_mask": q_mask,
                "gt_labels": gts,
                "valid": valid,
            }
