"""Host image preprocessing and image backends (copy of
``feddat_tpu/data/images.py``).

ViLT: shorter-side resize with a longer-side cap, fit-to-canvas, then either
the fp32 normalise-and-pad onto the fixed canvas with a pixel mask, or the
raw-uint8 canvas pack that the model normalises on the device.  ALBEF: an
exact bicubic resize to (384, 384), CLIP-normalised on the host or on the
device.  Backends map an image id to a file by each source's path
convention and decode it.  Kept byte-for-byte in step with the JAX package
so both see identical pixels.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence, Tuple

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


def finalize_vilt_u8(arr: np.ndarray, canvas: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """Normalize + pad a resized uint8 image onto the fixed canvas (the
    per-epoch half)."""
    a = (arr.astype(np.float32) / 255.0 - VILT_MEAN) / VILT_STD
    h, w = a.shape[:2]
    h, w = min(h, canvas[0]), min(w, canvas[1])
    out = np.zeros((canvas[0], canvas[1], 3), np.float32)
    mask = np.zeros((canvas[0], canvas[1]), np.int32)
    out[:h, :w] = a[:h, :w]
    mask[:h, :w] = 1
    return out, mask


def process_vilt_image(
    img: "Image.Image", canvas: Tuple[int, int] = (384, 640)
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (pixel_values [H, W, 3] float32 normalized, pixel_mask [H, W])."""
    return finalize_vilt_u8(vilt_resized_u8(img, canvas), canvas)


def vilt_resized_dims(w: int, h: int, canvas: Tuple[int, int]) -> Tuple[int, int]:
    """Analytic (h, w) after ``vilt_resized_u8``'s two-stage resize (the
    conditional shorter/longer rule, then fit-to-canvas), including each
    stage's rounding — the ONE definition of the resize arithmetic, shared
    by the decode path above and the pipeline's header-only bucket decision
    (``pipeline.ViltVQAPipeline._resized_wh``), so the two can never drift."""
    shorter, longer = min(canvas), max(canvas)
    if min(w, h) > shorter or max(w, h) > longer:
        scale = shorter / min(w, h)
        if max(w, h) * scale > longer:
            scale = longer / max(w, h)
        w, h = round(w * scale), round(h * scale)
    ch, cw = canvas
    if h > ch or w > cw:
        scale = min(ch / h, cw / w)
        w, h = max(1, round(w * scale)), max(1, round(h * scale))
    return h, w


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


def process_albef_image(img: "Image.Image", size: int = 384) -> np.ndarray:
    """-> pixel_values [size, size, 3] float32, CLIP-normalized."""
    arr = albef_resized_u8(img, size).astype(np.float32) / 255.0
    return (arr - CLIP_MEAN) / CLIP_STD


class ImageBackend:
    """Base: maps image_id -> file path, loads + decodes."""

    def path_for(self, image_id) -> str:
        raise NotImplementedError

    def load(self, image_id) -> "Image.Image":
        """Decode; on failure return a black image (the reference's only
        fault tolerance, ``src/utils/image_utils.py:56-60`` — a corrupt file
        must not kill a federated round).  Falls back LOUDLY: a misrooted
        image dir would otherwise train a whole run on black pixels with
        zero diagnostics, so the first miss (and every 1000th) is logged."""
        try:
            p = self.path_for(image_id)
            return Image.open(p).convert("RGB")
        except Exception as e:
            n = getattr(self, "_black_fallbacks", 0) + 1
            self._black_fallbacks = n
            if n == 1 or n % 1000 == 0:
                import logging

                logging.getLogger("feddat_tpu_torch").warning(
                    "image %r failed to load (%s); substituting a black "
                    "image (%d so far) — check the image roots if this is "
                    "not a rare corrupt file", image_id, e, n,
                )
            return Image.new("RGB", (384, 384))


class DirectoryScanBackend(ImageBackend):
    """COCO-style backends that scan directories and parse ids from filenames
    (reference ``cocoimages_dataset_crossvqas.py:39-65``).

    ``id_rule`` per task:
      abstract: int of last '_'-part of .png name; train/val routed by
        'train'/'val' substring;
      toronto:  int of last '_'-part of .jpg name, same routing;
      art:      int before '-' in .jpg name, single dir;
      pvqa/med: string stem.

    An id appearing in several scanned dirs resolves to the LAST dir's file
    — the same last-write-wins the reference's combined-listdir loop has
    (``cocoimages_dataset_crossvqas.py:46-65``; real splits don't collide).
    """

    def __init__(self, dirs: Sequence[str], task_key: str):
        self.task_key = task_key
        self.imageid2filename: Dict[object, str] = {}
        for d in dirs:
            if not os.path.isdir(d):
                continue
            for fn in os.listdir(d):
                image_id = self._parse_id(fn)
                if image_id is None:
                    continue
                self.imageid2filename[image_id] = os.path.join(d, fn)
        if not self.imageid2filename:
            # every lookup would fall back to a black image — say so ONCE up
            # front instead of letting a misrooted --climb_data_dir train a
            # whole run on black pixels silently
            import logging

            logging.getLogger("feddat_tpu_torch").warning(
                "image backend for %r scanned %s and found NO images; every "
                "sample will fall back to a black image", task_key, list(dirs),
            )

    def _parse_id(self, fn: str):
        stem = os.path.splitext(fn)[0]
        try:
            if self.task_key == "abstract":
                return int(stem.split("_")[-1])
            if self.task_key == "toronto":
                return int(stem.split("_")[-1])
            if self.task_key == "art":
                return int(stem.split("-")[0])
            return stem
        except ValueError:
            return None

    def path_for(self, image_id) -> str:
        hit = self.imageid2filename.get(image_id)
        if hit is not None:
            return hit
        # annotation-side ids arrive as full filename stems on the raw-JSON
        # build path (``datasets.py::build_examples_from_json`` keeps the
        # stem, matching the reference's live parse at
        # ``vqa_dataset_crossvqa.py:194``) — normalize them with the same
        # per-task rule used for the scanned filenames, so e.g. the stem
        # 'abstract_v002_train2015_000000000020' resolves to int key 20
        return self.imageid2filename[self._parse_id(str(image_id))]


class VisualGenomeBackend(ImageBackend):
    """VG images: ``{root}/{id}.jpg`` with the reference's ``'n'`` strip
    (``vgimages_dataset.py:44-47``)."""

    def __init__(self, root: str):
        self.root = root

    def path_for(self, image_id) -> str:
        image_id = str(image_id).replace("n", "")
        return os.path.join(self.root, f"{image_id}.jpg")


class VizwizBackend(ImageBackend):
    """VizWiz: image_id IS the filename (``vizwizimages_dataset.py:44-47``)."""

    def __init__(self, root: str):
        self.root = root

    def path_for(self, image_id) -> str:
        return os.path.join(self.root, str(image_id))


class CocoIdBackend(ImageBackend):
    """Plain COCO ``{split}2014/COCO_{split}2014_{id:012d}.jpg`` convention
    (non-federated VQAv2 path, ``cocoimages_dataset.py``)."""

    def __init__(self, root: str, splits=("train2014", "val2014")):
        self.imageid2filename: Dict[object, str] = {}
        for split in splits:
            d = os.path.join(root, split)
            if not os.path.isdir(d):
                continue
            for fn in os.listdir(d):
                stem = os.path.splitext(fn)[0]
                try:
                    image_id = int(stem.split("_")[-1])
                except ValueError:
                    continue
                self.imageid2filename[image_id] = os.path.join(d, fn)

    def path_for(self, image_id) -> str:
        return self.imageid2filename[int(image_id)]


class Flickr30kBackend(ImageBackend):
    """Flickr30K for SNLI-VE: ``{root}/{id}.jpg``."""

    def __init__(self, root: str):
        self.root = root

    def path_for(self, image_id) -> str:
        return os.path.join(self.root, f"{image_id}.jpg")


def make_backend(images_source: str, task_key: str, data_root: str = "./data") -> ImageBackend:
    """Backend routing (reference ``train_vqa_crossvqa.py`` image routing:
    VG for gqa/clove, vizwiz for vizwiz, COCO-style scans otherwise).
    Routing is decided by ``images_source`` alone; ``task_key`` is accepted
    for call-site symmetry (the id-parse rule is fixed per source here)."""
    if images_source in ("vg", "vgd"):
        return VisualGenomeBackend(os.path.join(data_root, "vg", "VG_100K"))
    if images_source == "vizwiz":
        return VizwizBackend(os.path.join(data_root, "vizwiz", "images"))
    if images_source == "abstract_image":
        return DirectoryScanBackend(
            [
                os.path.join(data_root, "vqa_abstract", "train2015"),
                os.path.join(data_root, "vqa_abstract", "val2015"),
            ],
            "abstract",
        )
    if images_source == "toronto_image":
        return DirectoryScanBackend(
            [
                os.path.join(data_root, "mscoco", "train2014"),
                os.path.join(data_root, "mscoco", "val2014"),
            ],
            "toronto",
        )
    if images_source == "art_image":
        return DirectoryScanBackend(
            [os.path.join(data_root, "AQUA", "SemArt", "Images")], "art"
        )
    if images_source == "ms-coco":
        return CocoIdBackend(os.path.join(data_root, "mscoco"))
    if images_source == "flickr30k":
        return Flickr30kBackend(os.path.join(data_root, "flickr30k", "images"))
    if images_source == "vcr":
        # VCR drawn-image paths are relative to the task dir
        # (reference ``vcr_dataset.py``: ``drawn_images/{split}/{type}/...``)
        return VizwizBackend(os.path.join(data_root, "vcr"))
    raise KeyError(f"unknown images_source {images_source!r}")
