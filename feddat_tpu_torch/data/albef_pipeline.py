"""ALBEF host pipeline: the answer bank of rank-answer serving and eval.

Counterpart of ``encode_answer_bank`` in ``feddat_tpu/data/albef_pipeline.py``
(``AlbefVQAPipeline`` comes with the host data path, ROADMAP Queue 1).
"""

from __future__ import annotations

from typing import Sequence


def encode_answer_bank(tokenizer, answers: Sequence[str], max_len: int):
    """answer list -> ([N, La] ids, [N, La] mask), CLS-prefixed."""
    return tokenizer.batch_encode(list(answers), max_len)
