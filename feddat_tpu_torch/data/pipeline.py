"""Host input pipeline and device prefetch (counterpart of
``feddat_tpu/data/pipeline.py``).

:class:`ViltVQAPipeline` turns (examples, image backend, tokenizer) into
fixed-shape ViLT batches: text padded to ``max_text_len``, images on a fixed
canvas, so a compiled step keeps one signature.  Its batches are bitwise the
JAX package's on the same examples.  The u8 image cache is normalised and
padded each epoch by the native host core (``feddat_tpu_torch/native``) when
it is available, else by the numpy finalize; both give the same bits.

:func:`prefetch_to_device` overlaps the host's batch assembly and the
host-to-device copy with the previous step (the JAX package prefetches two
batches with ``jax.device_put`` on an accelerator).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from feddat_tpu_torch.data.datasets import VQAExample
from feddat_tpu_torch.data.images import (
    VILT_MEAN,
    VILT_STD,
    finalize_vilt_u8,
    pack_u8_canvas,
    process_vilt_image,
    vilt_resized_dims,
    vilt_resized_u8,
)
from feddat_tpu_torch.data.vqa_scoring import target_tensor
from feddat_tpu_torch.device import DeviceLike, resolve_device
from feddat_tpu_torch.train.compiled import capture_lock


def shard_rows(n: int, shard: Tuple[int, int] = (0, 1)) -> slice:
    """Rows ``[d·n/D, (d+1)·n/D)`` of an ``n``-row batch for ``shard = (d, D)``:
    the SPMD engine's data rank ``d`` of ``D`` assembles only these."""
    d, D = shard
    if n % D:
        raise ValueError(f"a batch of {n} rows does not split over {D} data ranks")
    return slice(d * n // D, (d + 1) * n // D)


def iter_eval_chunks(examples: Sequence[Any], batch_size: int):
    """Yield ``(chunk, valid)`` fixed-size eval chunks: the final short chunk
    is padded by repeating element 0 with a zero ``valid`` mask, so the
    masked-sum eval counts exactly ``len(examples)``."""
    n = len(examples)
    for s in range(0, n, batch_size):
        chunk = list(examples[s : s + batch_size])
        pad = batch_size - len(chunk)
        valid = np.concatenate([np.ones(len(chunk)), np.zeros(pad)]).astype(np.float32)
        if pad:
            chunk = chunk + [examples[0]] * pad
        yield chunk, valid


class ViltVQAPipeline:
    """ViLT train/eval batches from (examples, image backend).

    Batch schema: input_ids [B, L], attention_mask [B, L], pixel_values
    [B, H, W, 3] (fp32 normalised, or raw uint8 with ``pixels_u8``),
    pixel_mask [B, H, W] (or the compact [B, 2] (h, w) with ``pixels_u8``),
    target_scores [B, C] (+ valid [B] on eval batches).

    ``pixels_u8`` (the CLI's ``--device_normalize``): raw uint8 pixels, which
    the model normalises on the device (``models/vilt.py``).  ``cache_images``
    keeps each image's decoded and resized uint8 array (up to
    ``cache_budget_bytes``, no eviction), so later epochs and rounds pay only
    the normalise-and-pad; the pixels are bitwise the uncached ones.
    ``canvas_bucket``: a train batch whose every image resizes to width <=
    min(canvas) pads onto the square (min, min) canvas; eval batches keep the
    full canvas.
    """

    def __init__(
        self,
        examples: Sequence[VQAExample],
        backend,
        tokenizer,
        num_labels: int = 100,
        max_text_len: int = 40,
        canvas: Tuple[int, int] = (384, 640),
        batch_size: int = 32,
        seed: int = 0,
        num_workers: int = 8,
        eval_examples: Optional[Sequence[VQAExample]] = None,
        cache_images: bool = False,
        cache_budget_bytes: int = 8 << 30,
        pixels_u8: bool = False,
        val_batch_size: Optional[int] = None,
        canvas_bucket: bool = False,
    ):
        self.examples = list(examples)
        # evaluation runs on its own split; without one, on the train examples
        self.eval_examples = list(eval_examples) if eval_examples is not None else self.examples
        self.backend = backend
        self.tokenizer = tokenizer
        self.num_labels = num_labels
        self.max_text_len = max_text_len
        self.canvas = canvas
        self.batch_size = batch_size
        self.val_batch_size = val_batch_size or batch_size
        self.seed = seed
        self.num_workers = num_workers
        self.pool = ThreadPoolExecutor(num_workers) if num_workers > 0 else None
        self.task_key = None
        self.pixels_u8 = pixels_u8
        # canvas bucketing applies only to the wide-landscape canvas layout
        self.canvas_bucket = bool(canvas_bucket) and canvas[1] > canvas[0]
        self._narrow_canvas = (canvas[0], canvas[0])
        self._size_cache: Dict[Any, Tuple[int, int]] = {}
        self._cache: Optional[Dict[Any, np.ndarray]] = {} if cache_images else None
        self._cache_left = cache_budget_bytes
        self._cache_lock = threading.Lock()
        self._native_finalize = None
        if cache_images:
            from feddat_tpu_torch import native

            if native.available():
                self._native_finalize = native.finalize_canvas_batch

    # the client-data protocol of the engine
    @property
    def num_train_examples(self) -> int:
        return len(self.examples)

    @property
    def num_eval_examples(self) -> int:
        return len(self.eval_examples)

    @property
    def steps_per_epoch(self) -> int:
        return len(self.examples) // self.batch_size

    def _load_one(self, ex: VQAExample, canvas=None):
        img = self.backend.load(ex.image_id)
        if canvas is None or canvas == self.canvas:
            return process_vilt_image(img, self.canvas)
        # a bucketed batch: the resize always follows the full canvas's rule;
        # only the zero-pad target shrinks
        return finalize_vilt_u8(vilt_resized_u8(img, self.canvas), canvas)

    def _resized_wh(self, ex: VQAExample) -> Tuple[int, int]:
        """(h, w) after the ViLT resize, from the image header alone (PIL
        reads no pixels for ``.size``), by the decode's own arithmetic."""
        cached = self._size_cache.get(ex.image_id)
        if cached is not None:
            return cached
        w, h = self.backend.load(ex.image_id).size
        hw = vilt_resized_dims(w, h, self.canvas)
        self._size_cache[ex.image_id] = hw
        return hw

    def _canvas_of(self, ex: VQAExample) -> Tuple[int, int]:
        if not self.canvas_bucket:
            return self.canvas
        _, w = self._resized_wh(ex)
        return self._narrow_canvas if w <= self._narrow_canvas[1] else self.canvas

    def _load_u8(self, ex: VQAExample) -> np.ndarray:
        """Decode and resize -> [h, w, 3] uint8 (cached when enabled)."""
        if self._cache is not None:
            cached = self._cache.get(ex.image_id)
            if cached is not None:
                return cached
        arr = vilt_resized_u8(self.backend.load(ex.image_id), self.canvas)
        if self._cache is not None:
            # the pool may load one image for two questions at once: the
            # check and the insert are one step, or the budget is charged twice
            with self._cache_lock:
                if ex.image_id not in self._cache and arr.nbytes <= self._cache_left:
                    self._cache[ex.image_id] = arr
                    self._cache_left -= arr.nbytes
        return arr

    def _map(self, fn, items):
        return list(self.pool.map(fn, items)) if self.pool is not None else [fn(e) for e in items]

    def _batch_images(self, batch_ex: List[VQAExample], canvas=None):
        """-> (pixels, masks): per image through PIL and numpy, or from the u8
        stage (cached or not) with the native or the numpy finalize; bitwise
        the same."""
        canvas = canvas or self.canvas
        if self._cache is None and not self.pixels_u8:
            images = self._map(lambda e: self._load_one(e, canvas), batch_ex)
            return np.stack([p for p, _ in images]), np.stack([m for _, m in images])
        u8s = self._map(self._load_u8, batch_ex)
        if self.pixels_u8:
            return pack_u8_canvas(u8s, canvas)
        if self._native_finalize is not None:
            return self._native_finalize(u8s, canvas, VILT_MEAN.tolist(), VILT_STD.tolist(),
                                         num_threads=max(1, self.num_workers))
        images = [finalize_vilt_u8(a, canvas) for a in u8s]
        return np.stack([p for p, _ in images]), np.stack([m for _, m in images])

    def _make_batch(self, batch_ex: List[VQAExample], valid: Optional[np.ndarray] = None,
                    canvas=None) -> Dict[str, np.ndarray]:
        pixels, masks = self._batch_images(batch_ex, canvas)
        ids, attn = self.tokenizer.batch_encode([e.question for e in batch_ex], self.max_text_len)
        targets = np.stack([target_tensor(self.num_labels, e.labels, e.scores) for e in batch_ex])
        batch = {"input_ids": ids, "attention_mask": attn, "pixel_values": pixels,
                 "pixel_mask": masks, "target_scores": targets}
        if valid is not None:
            batch["valid"] = valid
        return batch

    def train_batches(self, epoch: int = 0,
                      shard: Tuple[int, int] = (0, 1)) -> Iterator[Dict[str, np.ndarray]]:
        """``shard = (d, D)``: only rows :func:`shard_rows` of each batch are
        assembled (a batch's canvas is still its whole chunk's)."""
        rows = shard_rows(self.batch_size, shard)
        rng = np.random.RandomState(self.seed * 1000 + epoch)
        idx = rng.permutation(len(self.examples))
        if not self.canvas_bucket:
            for s in range(self.steps_per_epoch):
                sel = idx[s * self.batch_size : (s + 1) * self.batch_size][rows]
                yield self._make_batch([self.examples[i] for i in sel])
            return
        # stream the examples into per-canvas pools in permutation order and
        # flush full batches; the epoch still yields steps_per_epoch batches
        pools: Dict[Tuple[int, int], List[VQAExample]] = {}
        emitted = 0
        for i in idx:
            if emitted >= self.steps_per_epoch:
                return
            ex = self.examples[i]
            canvas = self._canvas_of(ex)
            pool = pools.setdefault(canvas, [])
            pool.append(ex)
            if len(pool) == self.batch_size:
                pools[canvas] = []
                emitted += 1
                yield self._make_batch(pool[rows], canvas=canvas)
        # top up with the leftovers of both pools as full batches
        rest = [e for pool in pools.values() for e in pool]
        while emitted < self.steps_per_epoch and len(rest) >= self.batch_size:
            chunk, rest = rest[: self.batch_size], rest[self.batch_size :]
            canvas = self.canvas if any(
                self._canvas_of(e) == self.canvas for e in chunk) else self._narrow_canvas
            emitted += 1
            yield self._make_batch(chunk[rows], canvas=canvas)

    def eval_batches(self, shard: Tuple[int, int] = (0, 1)) -> Iterator[Dict[str, np.ndarray]]:
        rows = shard_rows(self.val_batch_size, shard)
        for chunk, valid in iter_eval_chunks(self.eval_examples, self.val_batch_size):
            yield self._make_batch(chunk[rows], valid[rows])


class _PinnedRing:
    """The host side of the card's prefetch: for each array of a batch (by
    name, shape and dtype) a few pinned buffers, allocated once and used in
    turn, and one copy stream per device.  A buffer is written again only
    after the event of the copy that last read it has completed, so any
    number of prefetchers may share the ring; every batch gets device
    tensors of its own."""

    def __init__(self):
        self.buffers: Dict[tuple, List[list]] = {}
        self.turn: Dict[tuple, int] = {}
        self.streams: Dict[torch.device, "torch.cuda.Stream"] = {}

    def stage(self, batch: Dict[str, Any], device: torch.device, slots: int):
        """Copy ``batch`` (numpy arrays) through pinned buffers onto
        ``device`` on the copy stream -> (tensors, the copies' event)."""
        stream = self.streams.get(device)
        if stream is None:
            stream = self.streams[device] = torch.cuda.Stream(device)
        out: Dict[str, torch.Tensor] = {}
        used = []
        with torch.cuda.stream(stream):
            for name, value in batch.items():
                src = torch.from_numpy(np.ascontiguousarray(value))
                key = (device, name, tuple(src.shape), src.dtype)
                ring = self.buffers.setdefault(key, [])
                while len(ring) < slots:
                    ring.append([torch.empty(src.shape, dtype=src.dtype, pin_memory=True), None])
                i = self.turn.get(key, 0) % len(ring)
                self.turn[key] = i + 1
                pinned, last_read = ring[i]
                if last_read is not None:
                    last_read.synchronize()
                pinned.copy_(src)
                out[name] = torch.empty(src.shape, dtype=src.dtype, device=device)
                out[name].copy_(pinned, non_blocking=True)
                used.append(ring[i])
            event = torch.cuda.Event()
            event.record(stream)
        for slot in used:
            slot[1] = event
        return out, event


_RING = _PinnedRing()


def prefetch_to_device(it: Iterable[Dict[str, Any]], size: int = 2,
                       device: DeviceLike = None) -> Iterator[Dict[str, torch.Tensor]]:
    """Stage ``size`` batches ahead of the consumer from a producer thread.

    On the card (the default device): each array goes through a pinned host
    buffer of a ring allocated once per shape, and onto the card by a
    non-blocking copy on a dedicated copy stream; the consumer's stream
    waits on that batch's event, and each tensor is marked as used by the
    consumer's stream (``record_stream``) before it is handed over.  The
    producer pauses while a CUDA graph is being captured
    (``train.compiled.capture_lock``).  A failure to pin or to copy raises in
    the consumer; nothing falls back to pageable or synchronous copies.  With
    ``device="cpu"`` the same thread and queue hand over CPU tensors.

    Errors of the producer (including the source iterator's) reach the
    consumer.  A consumer that abandons the generator stops the producer
    instead of leaving it blocked on a full queue."""
    device = resolve_device(device)
    return _prefetch(it, size, device)


def _prefetch(it, size: int, device: torch.device):
    q: "queue.Queue" = queue.Queue(maxsize=size)
    end = object()
    stop = threading.Event()
    on_card = device.type == "cuda"

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def stage(batch):
        if not on_card:
            return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        with capture_lock:
            return _RING.stage(batch, device, size + 1)

    def producer():
        try:
            for batch in it:
                if not put(stage(batch)):
                    return
            put(end)
        except BaseException as e:  # noqa: BLE001 - raised again in the consumer
            put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                break
            if isinstance(item, BaseException):
                raise item
            if on_card:
                tensors, event = item
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(event)
                for v in tensors.values():
                    v.record_stream(consumer)
                item = tensors
            yield item
    finally:
        stop.set()
        while True:  # unblock a producer waiting on a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                break
