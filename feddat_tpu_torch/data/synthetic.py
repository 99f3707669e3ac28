"""Deterministic in-memory VQA clients (numpy twins of
``feddat_tpu/data/synthetic.py``: ``SyntheticVQAClient`` and
``SyntheticAlbefClient``).

With the same arguments and seed each yields bitwise the same batches as the
JAX package's client: the same numpy draws in the same order.  The batch
schemas are the real collators'; the answer is a learnable function of the
inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np

from feddat_tpu_torch.data.pipeline import shard_rows


@dataclasses.dataclass
class SyntheticVQAClient:
    """One fake federated client with ViLT-style VQA batches.

    Batch schema (what the real collator produces,
    cf. ``vqa_dataset_crossvqa.py:377-422``):
      input_ids [B, L] int32, attention_mask [B, L] int32,
      pixel_values [B, H, W, 3] float32, target_scores [B, num_labels]
      (+ ``valid`` [B] float32 on eval batches).
    """

    task_key: str
    num_train: int = 32
    num_eval: int = 16
    num_labels: int = 16
    vocab_size: int = 100
    text_len: int = 8
    image_size: Tuple[int, int] = (32, 32)
    batch_size: int = 4
    val_batch_size: int = 4
    seed: int = 0

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        n = self.num_train + self.num_eval
        self.input_ids = rng.randint(1, self.vocab_size, size=(n, self.text_len)).astype(np.int32)
        lengths = rng.randint(self.text_len // 2, self.text_len + 1, size=(n,))
        self.attention_mask = (
            np.arange(self.text_len)[None, :] < lengths[:, None]
        ).astype(np.int32)
        self.input_ids *= self.attention_mask  # pad ids -> 0
        self.pixel_values = rng.randn(n, self.image_size[0], self.image_size[1], 3).astype(
            np.float32
        )
        # Learnable signal: the answer is a function of the first token and
        # the sign of the mean pixel.
        answer = (
            self.input_ids[:, 0] + (self.pixel_values.mean(axis=(1, 2, 3)) > 0)
        ) % self.num_labels
        self.answers = answer.astype(np.int64)
        self.target_scores = np.zeros((n, self.num_labels), dtype=np.float32)
        self.target_scores[np.arange(n), answer] = 1.0
        # sprinkle soft secondary answers like real VQA soft targets
        second = (answer + 1) % self.num_labels
        self.target_scores[np.arange(n), second] = 0.3

    # -- sizes -------------------------------------------------------------
    @property
    def num_train_examples(self) -> int:
        return self.num_train

    @property
    def num_eval_examples(self) -> int:
        return self.num_eval

    @property
    def steps_per_epoch(self) -> int:
        return self.num_train // self.batch_size

    # -- iterators ---------------------------------------------------------
    def train_batches(self, epoch: int = 0,
                      shard: Tuple[int, int] = (0, 1)) -> Iterator[Dict[str, np.ndarray]]:
        """Shuffled fixed-size train batches (drop-last, like the reference's
        ALBEF loader; the ViLT loader's shuffle-always quirk is made explicit
        here as deterministic per-epoch shuffling).  ``shard = (d, D)``: only
        rows ``shard_rows`` of each batch."""
        rows = shard_rows(self.batch_size, shard)
        rng = np.random.RandomState(self.seed * 1000 + epoch)
        idx = rng.permutation(self.num_train)
        for s in range(self.steps_per_epoch):
            sel = idx[s * self.batch_size : (s + 1) * self.batch_size][rows]
            yield {
                "input_ids": self.input_ids[sel],
                "attention_mask": self.attention_mask[sel],
                "pixel_values": self.pixel_values[sel],
                "target_scores": self.target_scores[sel],
            }

    def eval_batches(self, shard: Tuple[int, int] = (0, 1)) -> Iterator[Dict[str, np.ndarray]]:
        """Fixed-size eval batches, final batch zero-padded with a ``valid``
        mask (replaces the reference's gather + truncation,
        ``task_trainer.py:129-156``)."""
        start = self.num_train
        n = self.num_eval
        bs = self.val_batch_size
        rows = shard_rows(bs, shard)
        for s in range(0, n, bs):
            sel = np.arange(start + s, start + min(s + bs, n))
            pad = bs - len(sel)
            valid = np.concatenate([np.ones(len(sel)), np.zeros(pad)]).astype(np.float32)
            sel = np.concatenate([sel, np.full(pad, start, dtype=sel.dtype)])
            sel, valid = sel[rows], valid[rows]
            yield {
                "input_ids": self.input_ids[sel],
                "attention_mask": self.attention_mask[sel],
                "pixel_values": self.pixel_values[sel],
                "target_scores": self.target_scores[sel],
                "valid": valid,
            }


@dataclasses.dataclass
class SyntheticAlbefClient:
    """Fake client with ALBEF-schema batches (dense answer bank).

    Train: pixel_values, question_ids/mask, answer_ids/mask [B, A, La],
    answer_weights [B, A].  Eval: + gt_labels [B, G] (-1 padded), valid.
    The answer bank maps label i -> a distinct single-token answer.
    """

    task_key: str
    num_train: int = 16
    num_eval: int = 8
    num_answers: int = 8
    vocab_size: int = 64
    question_len: int = 6
    answer_len: int = 4
    max_answers_per_q: int = 2
    image_size: Tuple[int, int] = (32, 32)
    batch_size: int = 4
    val_batch_size: int = 4
    seed: int = 0
    pad_token_id: int = 0
    bos_token_id: int = 1

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        n = self.num_train + self.num_eval
        # reserved: 0=pad, 1=bos/cls; answer tokens 2..2+num_answers
        self.answer_ids = np.zeros((self.num_answers, self.answer_len), np.int32)
        self.answer_mask = np.zeros((self.num_answers, self.answer_len), np.int32)
        for a in range(self.num_answers):
            self.answer_ids[a, :2] = [self.bos_token_id, 2 + a]
            self.answer_mask[a, :2] = 1
        self.question_ids = rng.randint(
            2 + self.num_answers, self.vocab_size, size=(n, self.question_len)
        ).astype(np.int32)
        self.question_ids[:, 0] = self.bos_token_id
        self.question_mask = np.ones((n, self.question_len), np.int32)
        self.pixel_values = rng.randn(n, *self.image_size, 3).astype(np.float32)
        self.gt = (self.question_ids[:, 1] % self.num_answers).astype(np.int64)

    @property
    def num_train_examples(self):
        return self.num_train

    @property
    def num_eval_examples(self):
        return self.num_eval

    @property
    def steps_per_epoch(self):
        return self.num_train // self.batch_size

    def train_batches(self, epoch: int = 0,
                      shard: Tuple[int, int] = (0, 1)) -> Iterator[Dict[str, np.ndarray]]:
        rows = shard_rows(self.batch_size, shard)
        rng = np.random.RandomState(self.seed * 1000 + epoch)
        idx = rng.permutation(self.num_train)
        A, La = self.max_answers_per_q, self.answer_len
        for s in range(self.steps_per_epoch):
            sel = idx[s * self.batch_size : (s + 1) * self.batch_size][rows]
            B = len(sel)
            ans_ids = np.zeros((B, A, La), np.int32)
            ans_mask = np.zeros((B, A, La), np.int32)
            weights = np.zeros((B, A), np.float32)
            for i, j in enumerate(sel):
                ans_ids[i, 0] = self.answer_ids[self.gt[j]]
                ans_mask[i, 0] = self.answer_mask[self.gt[j]]
                weights[i, 0] = 1.0
            yield {
                "pixel_values": self.pixel_values[sel],
                "question_ids": self.question_ids[sel],
                "question_mask": self.question_mask[sel],
                "answer_ids": ans_ids,
                "answer_mask": ans_mask,
                "answer_weights": weights,
            }

    def eval_batches(self, shard: Tuple[int, int] = (0, 1)) -> Iterator[Dict[str, np.ndarray]]:
        start, n, bs = self.num_train, self.num_eval, self.val_batch_size
        rows = shard_rows(bs, shard)
        for s in range(0, n, bs):
            sel = np.arange(start + s, start + min(s + bs, n))
            pad = bs - len(sel)
            valid = np.concatenate([np.ones(len(sel)), np.zeros(pad)]).astype(np.float32)
            sel = np.concatenate([sel, np.full(pad, start, dtype=sel.dtype)])
            sel, valid = sel[rows], valid[rows]
            yield {
                "pixel_values": self.pixel_values[sel],
                "question_ids": self.question_ids[sel],
                "question_mask": self.question_mask[sel],
                "gt_labels": self.gt[sel][:, None],
                "valid": valid,
            }
