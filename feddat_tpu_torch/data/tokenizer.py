"""Self-contained WordPiece tokenizer (BERT-uncased compatible).

Copy of ``feddat_tpu/data/tokenizer.py`` (pure Python, kept identical so
both packages give the same ids): greedy longest-match-first WordPiece over
a basic whitespace + punctuation + lowercase pre-tokenizer.  Load the
standard ``bert-base-uncased`` ``vocab.txt`` for checkpoint-compatible ids;
tests use a tiny synthetic vocab.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, List, Optional, Sequence

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_whitespace(ch: str) -> bool:
    if ch in " \t\n\r":
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in "\t\n\r":
        return False
    return unicodedata.category(ch).startswith("C")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


def _strip_accents(text: str) -> str:
    text = unicodedata.normalize("NFD", text)
    return "".join(ch for ch in text if unicodedata.category(ch) != "Mn")


def _split_on_punc(token: str) -> List[str]:
    out: List[str] = []
    current: List[str] = []
    for ch in token:
        if _is_punctuation(ch):
            if current:
                out.append("".join(current))
                current = []
            out.append(ch)
        else:
            current.append(ch)
    if current:
        out.append("".join(current))
    return out


def _basic_tokenize(
    text: str, lowercase: bool = True, never_split: Sequence[str] = ()
) -> List[str]:
    """BERT BasicTokenizer parity: clean text (drop control chars, normalize
    whitespace), space out CJK chars, whitespace-split, keep never-split
    specials verbatim, else lowercase -> strip accents -> split punctuation.
    Matches HF ``BertTokenizer`` (reference vendors it verbatim,
    ``tokenization_bert.py``); parity tested in
    ``tests/test_tokenizer_hf_parity.py``."""
    cleaned: List[str] = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_cjk(cp):
            cleaned.append(f" {ch} ")
        elif _is_whitespace(ch):
            cleaned.append(" ")
        else:
            cleaned.append(ch)
    out: List[str] = []
    for token in "".join(cleaned).split():
        if token in never_split:
            out.append(token)
            continue
        if lowercase:
            token = _strip_accents(token.lower())
        out.extend(_split_on_punc(token))
    return out


class WordPieceTokenizer:
    def __init__(
        self,
        vocab: Dict[str, int],
        lowercase: bool = True,
        max_input_chars_per_word: int = 100,
    ):
        self.vocab = vocab
        self.ids_to_tokens = {v: k for k, v in vocab.items()}
        self.lowercase = lowercase
        self.max_input_chars_per_word = max_input_chars_per_word
        self.pad_token_id = vocab[PAD]
        self.unk_token_id = vocab[UNK]
        self.cls_token_id = vocab[CLS]
        self.sep_token_id = vocab[SEP]

    @classmethod
    def from_vocab_file(cls, path: str, **kwargs) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, **kwargs)

    @classmethod
    def toy(cls, words: Sequence[str]) -> "WordPieceTokenizer":
        """Tiny vocab for tests: specials + whole words + single chars."""
        tokens = [PAD, UNK, CLS, SEP, MASK]
        tokens += sorted(set(words))
        chars = sorted({c for w in words for c in w})
        tokens += [c for c in chars if c not in tokens]
        tokens += ["##" + c for c in chars]
        return cls({t: i for i, t in enumerate(tokens)})

    # -- core --------------------------------------------------------------
    def wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_input_chars_per_word:
            return [UNK]
        start, pieces = 0, []
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = piece
                    break
                end -= 1
            if cur is None:
                return [UNK]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out = []
        specials = (PAD, UNK, CLS, SEP, MASK)
        for word in _basic_tokenize(text, self.lowercase, never_split=specials):
            out.extend(self.wordpiece(word))
        return out

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        return [self.vocab.get(t, self.unk_token_id) for t in tokens]

    def encode(
        self,
        text: str,
        max_length: Optional[int] = None,
        add_special_tokens: bool = True,
    ) -> List[int]:
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        if add_special_tokens:
            budget = None if max_length is None else max(0, max_length - 2)
            if budget is not None:
                ids = ids[:budget]
            ids = [self.cls_token_id] + ids + [self.sep_token_id]
        elif max_length is not None:
            ids = ids[:max_length]
        return ids

    def batch_encode(
        self, texts: Sequence[str], max_length: int, add_special_tokens: bool = True
    ):
        """Fixed-shape padded batch: (ids [B, L], mask [B, L]) int32 numpy."""
        import numpy as np

        ids = np.full((len(texts), max_length), self.pad_token_id, dtype=np.int32)
        mask = np.zeros((len(texts), max_length), dtype=np.int32)
        for i, t in enumerate(texts):
            enc = self.encode(t, max_length=max_length, add_special_tokens=add_special_tokens)
            enc = enc[:max_length]
            ids[i, : len(enc)] = enc
            mask[i, : len(enc)] = 1
        return ids, mask

    def decode(self, ids: Sequence[int], skip_special: bool = True) -> str:
        toks = [self.ids_to_tokens.get(int(i), UNK) for i in ids]
        if skip_special:
            toks = [t for t in toks if t not in (PAD, UNK, CLS, SEP, MASK)]
        text = ""
        for t in toks:
            if t.startswith("##"):
                text += t[2:]
            else:
                text += (" " if text else "") + t
        return text
