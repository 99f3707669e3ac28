"""Host image preprocessing (copy of the serving half of
``feddat_tpu/data/images.py``).

ViLT: shorter-side resize with a longer-side cap, fit-to-canvas, and the
raw-uint8 canvas pack that the model normalises on the device.  ALBEF: an
exact bicubic resize to (384, 384) uint8, CLIP-normalised on the device.
Kept byte-for-byte in step with the JAX package so both predictors see
identical pixels.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from PIL import Image

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
VILT_MEAN = np.array([0.5, 0.5, 0.5], np.float32)
VILT_STD = np.array([0.5, 0.5, 0.5], np.float32)
_ON_DEVICE: Dict[Tuple[str, torch.device], torch.Tensor] = {}


def normalize_u8(x: torch.Tensor, stats: str) -> torch.Tensor:
    """``(x / 255 − mean) / std`` on ``x``'s device, fp32, with ``stats``
    "vilt" or "clip".  The statistics go to the device once per process: a
    CUDA graph's capture cannot copy from pageable host memory, and the
    warm-up call before it makes the copy."""
    key = (stats, x.device)
    if key not in _ON_DEVICE:
        mean, std = (VILT_MEAN, VILT_STD) if stats == "vilt" else (CLIP_MEAN, CLIP_STD)
        _ON_DEVICE[key] = torch.from_numpy(np.stack([mean, std])).to(x.device)
    mean_std = _ON_DEVICE[key]
    return (x.to(torch.float32) / 255.0 - mean_std[0]) / mean_std[1]


def vilt_resize(img: Image.Image, shorter: int = 384, longer: int = 640) -> Image.Image:
    """Shorter-side resize with longer-side cap (HF ViltImageProcessor rule)."""
    w, h = img.size
    scale = shorter / min(w, h)
    if max(w, h) * scale > longer:
        scale = longer / max(w, h)
    nw, nh = round(w * scale), round(h * scale)
    return img.resize((nw, nh), Image.BICUBIC)


def vilt_resized_u8(img: Image.Image, canvas: Tuple[int, int] = (384, 640)) -> np.ndarray:
    """The conditional shorter-side resize, then a downscale to fit the
    canvas, as a [h, w, 3] uint8 array (thresholds scale with the canvas)."""
    ch, cw = canvas
    shorter, longer = min(canvas), max(canvas)
    if min(img.size) > shorter or max(img.size) > longer:
        img = vilt_resize(img, shorter, longer)
    w, h = img.size
    if h > ch or w > cw:
        scale = min(ch / h, cw / w)
        img = img.resize(
            (max(1, round(w * scale)), max(1, round(h * scale))), Image.BICUBIC
        )
    return np.asarray(img.convert("RGB"), np.uint8)


def pack_u8_canvas(u8s, canvas: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """Resized uint8 images -> (pixels [B, H, W, 3] u8 on the zero-padded
    canvas, dims [B, 2] (h, w) extents of each image's valid rectangle)."""
    H, W = canvas
    out = np.zeros((len(u8s), H, W, 3), np.uint8)
    dims = np.zeros((len(u8s), 2), np.int32)
    for i, a in enumerate(u8s):
        h, w = min(a.shape[0], H), min(a.shape[1], W)
        out[i, :h, :w] = a[:h, :w]
        dims[i] = (h, w)
    return out, dims


def albef_resized_u8(img: Image.Image, size: int = 384) -> np.ndarray:
    """Exact bicubic resize to (size, size), as a [size, size, 3] uint8 array."""
    return np.asarray(img.convert("RGB").resize((size, size), Image.BICUBIC), np.uint8)
