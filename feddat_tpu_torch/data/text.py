"""Question normalisation (copy of ``pre_question`` in ``feddat_tpu/data/text.py``):
ALBEF's cleanup — lowercase, strip punctuation, dash/slash -> space, truncate
to ``max_ques_words`` words."""

from __future__ import annotations

import re


def pre_question(question: str, max_ques_words: int) -> str:
    """ALBEF question normalization + truncation."""
    question = (
        re.sub(r"([,.'!?\"()*#:;~])", "", question.lower())
        .replace("-", " ")
        .replace("/", " ")
    )
    question = question.rstrip(" ")
    words = question.split(" ")
    if len(words) > max_ques_words:
        question = " ".join(words[:max_ques_words])
    return question
