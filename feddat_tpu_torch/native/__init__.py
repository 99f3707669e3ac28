"""ctypes bindings for the native host-pipeline core (counterpart of
``feddat_tpu/native/``).

``feddat_native.cpp`` (this package's own copy) is compiled with ``g++`` into
``feddat_tpu_torch/_build/`` the first time it is used, under
``ops/_build.py``'s build lock, and loaded through its plain C ABI:

  * :func:`resize_normalize_batch`: GIL-free multithreaded bilinear resize
    and normalization into the batch buffer;
  * :func:`finalize_canvas_batch`: the cached u8 images normalized and
    zero-padded onto the canvas in one pass, the per-epoch half of the
    pipelines' image cache, bitwise the numpy finalize;
  * :class:`NativeWordPiece`: the C++ WordPiece batch tokenizer.

The library's name carries a hash of the source and the flags, so an edited
source rebuilds.  When the compiler is missing or the build fails,
:func:`available` is False, the failure is logged once at WARNING with the
compiler's output, and callers take the Python paths, as in the JAX package.
This is host code: it needs no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from feddat_tpu_torch.ops import _build

logger = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent / "feddat_native.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_lib = None
_build_error: Optional[str] = None


def library_path() -> Path:
    """``_build/libfeddat_native-<hash>.so`` for the current source and flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return _build.BUILD_DIR / f"libfeddat_native-{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    """g++ into a process-unique temporary name, then an atomic rename: two
    processes building at once each load a whole library."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)], check=True,
                       capture_output=True, text=True, timeout=300)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.resize_normalize_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.finalize_canvas_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.wp_create.restype = ctypes.c_void_p
    lib.wp_create.argtypes = [ctypes.c_char_p] + [ctypes.c_int32] * 4
    lib.wp_destroy.argtypes = [ctypes.c_void_p]
    lib.wp_encode_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
    ]
    return lib


def _load():
    global _lib, _build_error
    with _build.BUILD_LOCK:
        if _lib is not None or _build_error is not None:
            return _lib
        out = library_path()
        try:
            if not out.exists():
                _compile(out)
            _lib = _bind(ctypes.CDLL(str(out)))
        except subprocess.CalledProcessError as e:
            _build_error = f"g++ exited {e.returncode}:\n{e.stdout}{e.stderr}"
        except (OSError, AttributeError, subprocess.SubprocessError) as e:
            _build_error = f"{type(e).__name__}: {e}"
        if _build_error is not None:
            logger.warning("native host core unavailable, the pipelines take the numpy "
                           "finalize and the Python WordPiece: %s", _build_error)
        return _lib


def available() -> bool:
    return _load() is not None


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_build_error}")
    return lib


def resize_normalize_batch(
    images: np.ndarray,
    out_hw: Tuple[int, int],
    mean: Sequence[float],
    std: Sequence[float],
    num_threads: int = 8,
) -> np.ndarray:
    """[N, H, W, 3] uint8 -> [N, oh, ow, 3] float32 normalized (bilinear)."""
    lib = _require()
    images = np.ascontiguousarray(images, dtype=np.uint8)
    n, h, w, c = images.shape
    if c != 3:
        raise ValueError(f"resize_normalize_batch needs [N, H, W, 3] uint8; got {images.shape}")
    oh, ow = out_hw
    out = np.empty((n, oh, ow, 3), np.float32)
    mean_a = np.asarray(mean, np.float32)
    std_a = np.asarray(std, np.float32)
    lib.resize_normalize_batch(
        images.ctypes.data, n, h, w,
        out.ctypes.data, oh, ow,
        mean_a.ctypes.data, std_a.ctypes.data, num_threads,
    )
    return out


def finalize_canvas_batch(
    images: Sequence[np.ndarray],
    canvas: Tuple[int, int],
    mean: Sequence[float],
    std: Sequence[float],
    num_threads: int = 8,
    with_mask: bool = True,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Variable-size [h_i, w_i, 3] uint8 images -> zero-padded normalized
    float32 [N, H, W, 3] batch (+ int32 pixel mask) in one GIL-free pass,
    bitwise the numpy path ((x/255 - mean)/std in f32)."""
    lib = _require()
    n = len(images)
    H, W = canvas
    images = [np.ascontiguousarray(im, dtype=np.uint8) for im in images]
    for im in images:
        # the C side reads h*w*3 bytes per image: anything else would be an
        # out-of-bounds read, not a Python error
        if im.ndim != 3 or im.shape[2] != 3:
            raise ValueError(f"finalize_canvas_batch needs [h, w, 3] uint8 images; got shape {im.shape}")
    ptrs = (ctypes.c_void_p * n)(*[im.ctypes.data for im in images])
    hw = np.asarray([[im.shape[0], im.shape[1]] for im in images], np.int64)
    out = np.empty((n, H, W, 3), np.float32)
    mask = np.empty((n, H, W), np.int32) if with_mask else None
    mean_a = np.asarray(mean, np.float32)
    std_a = np.asarray(std, np.float32)
    lib.finalize_canvas_batch(
        ptrs, hw.ctypes.data, n,
        out.ctypes.data, mask.ctypes.data if with_mask else None, H, W,
        mean_a.ctypes.data, std_a.ctypes.data, num_threads,
    )
    return out, mask


class NativeWordPiece:
    """C++ WordPiece over a vocab mapping (token -> id by line order), with
    :class:`~feddat_tpu_torch.data.tokenizer.WordPieceTokenizer`'s interface:
    the batch path is native, the per-string methods delegate to the Python
    tokenizer."""

    def __init__(self, vocab: dict, unk="[UNK]", cls="[CLS]", sep="[SEP]", pad="[PAD]"):
        from feddat_tpu_torch.data.tokenizer import WordPieceTokenizer

        lib = _require()
        self._lib = lib
        ordered = sorted(vocab.items(), key=lambda kv: kv[1])
        if [i for _, i in ordered] != list(range(len(ordered))):
            raise ValueError("vocab ids must be dense")
        blob = "\n".join(t for t, _ in ordered).encode("utf-8")
        self._handle = lib.wp_create(blob, vocab[unk], vocab[cls], vocab[sep], vocab[pad])
        self.vocab = vocab
        self.pad_token_id = vocab[pad]
        self.cls_token_id = vocab[cls]
        self.sep_token_id = vocab[sep]
        self._py = WordPieceTokenizer(vocab)

    def tokenize(self, text):
        return self._py.tokenize(text)

    def convert_tokens_to_ids(self, tokens):
        return self._py.convert_tokens_to_ids(tokens)

    def encode(self, text, max_length=None, add_special_tokens=True):
        return self._py.encode(text, max_length=max_length, add_special_tokens=add_special_tokens)

    def decode(self, ids, skip_special=True):
        return self._py.decode(ids, skip_special=skip_special)

    def batch_encode(self, texts: Sequence[str], max_length: int, num_threads: int = 8):
        """HF-parity batch encode: the C++ path covers the ASCII subset of
        BERT's basic tokenization exactly; a non-ASCII string goes through the
        Python tokenizer, so the ids are the same either way."""
        n = len(texts)
        ids = np.empty((n, max_length), np.int32)
        mask = np.empty((n, max_length), np.int32)
        non_ascii = [i for i, t in enumerate(texts) if not t.isascii()]
        # NUL separates the strings of the blob; BERT's clean_text drops NULs
        blob = b"\x00".join(
            (t.replace("\x00", "") if t.isascii() else "").encode("utf-8") for t in texts
        ) + b"\x00"
        self._lib.wp_encode_batch(self._handle, blob, n, ids.ctypes.data, mask.ctypes.data,
                                  max_length, num_threads)
        for i in non_ascii:
            enc = self._py.encode(texts[i], max_length=max_length)
            ids[i] = self.pad_token_id
            mask[i] = 0
            ids[i, : len(enc)] = enc
            mask[i, : len(enc)] = 1
        return ids, mask

    def __del__(self):
        try:
            self._lib.wp_destroy(self._handle)
        except Exception:
            pass
