"""Logging, metrics and profiling (counterpart of
``feddat_tpu/utils/observability.py``).

  * ``experiment_name``: the config-encoded run name, the JAX CLI's for the
    same flags;
  * ``setup_logger``: stream and file handlers on process 0 of the
    ``torch.distributed`` group (the only process without one), errors only
    elsewhere;
  * ``MetricsLogger``: the JSONL metrics stream (``run_start``; ``step``
    every ``log_every`` steps with samples/sec; ``round`` with the scores and
    the round's wall time) with an optional W&B sink (a gated import);
  * ``trace``: a ``torch.profiler`` window with CPU and CUDA activities,
    written as a Chrome-trace JSON file under its directory (open it in
    Perfetto or ``chrome://tracing``).

``enable_compilation_cache`` has no counterpart: a CUDA graph belongs to the
process that captured it, and what persists across launches is the kernel
build directory (``ops/_build.py``).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import socket
import time
from typing import Any, Dict, Iterator, Optional

from feddat_tpu_torch.utils.seeding import process_index


def experiment_name(config) -> str:
    """Config-encoded run name (analogue of ``main.py:335``)."""
    fed = config.federated
    return (
        f"{config.encoder_name}_{config.peft_mode.value}"
        f"_bs{config.batch_size}_lr{config.optimizer.lr}"
        f"_rounds{fed.comm_rounds}x{fed.local_epochs}_seed{config.seed}"
    )


def setup_logger(
    log_dir: Optional[str] = None,
    name: str = "feddat_tpu_torch",
    level: int = logging.INFO,
    run_name: Optional[str] = None,
) -> logging.Logger:
    """Process 0 gets stream (and file) handlers; other processes log errors
    only (the reference's rank-aware root logger, ``main.py:67-99``).  The
    port's modules log under ``feddat_tpu_torch.*``, so they reach the file."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if process_index() != 0:
        logger.setLevel(logging.ERROR)
        return logger
    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    # by exact type: FileHandler subclasses StreamHandler, so an isinstance
    # check would let an earlier file-only setup suppress the console forever
    if not any(type(h) is logging.StreamHandler for h in logger.handlers):
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.abspath(os.path.join(log_dir, f"{run_name or 'run'}.log"))
        # a second setup (a programmatic main() run twice) must not stack a
        # second handler on the same file
        if not any(isinstance(h, logging.FileHandler) and h.baseFilename == path
                   for h in logger.handlers):
            fh = logging.FileHandler(path, "w")
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


class MetricsLogger:
    """JSONL metrics with throughput accounting and an optional W&B sink."""

    def __init__(
        self,
        path: Optional[str] = None,
        log_every: int = 100,
        wandb_project: Optional[str] = None,
        wandb_run_name: Optional[str] = None,
    ):
        self.path = path
        self.log_every = log_every
        self._fh = open(path, "a") if path else None
        self._step = 0
        self._step_t0 = None
        self._samples = 0
        self._wandb = None
        if wandb_project:
            try:  # never a hard dependency
                import wandb

                self._wandb = wandb.init(project=wandb_project, name=wandb_run_name)
            except Exception:
                self._wandb = None
        if self._fh:
            # the file appends across relaunches (a resumed run keeps the
            # earlier rounds' records); the marker separates the runs
            self._emit({"kind": "run_start"})

    def _emit(self, record: Dict[str, Any]):
        record = {"ts": time.time(), **record}
        if self._fh:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in record.items() if isinstance(v, (int, float))})
        return record

    def step(self, metrics: Dict[str, Any], batch_size: int, task_key: str = ""):
        """Per-train-step hook; every ``log_every`` steps a record with the
        samples/sec since the last one.  A device scalar is read back only
        then."""
        self._step += 1
        self._samples += batch_size
        if self._step_t0 is None:
            self._step_t0 = time.time()
        if self._step % self.log_every == 0:
            dt = time.time() - self._step_t0
            rec = {
                "kind": "step",
                "task": task_key,
                "step": self._step,
                "samples_per_sec": self._samples / max(dt, 1e-9),
                **{k: float(v) for k, v in metrics.items()},
            }
            self._step_t0 = time.time()
            self._samples = 0
            self._emit(rec)

    def logs_next(self) -> bool:
        """Whether the next :meth:`step` writes a record (reads its metrics)."""
        return (self._step + 1) % self.log_every == 0

    def round(self, round_idx: int, scores: Dict[str, Any], wall_s: float):
        self._emit({"kind": "round", "round": round_idx, "scores": scores, "wall_s": wall_s})

    def close(self):
        if self._fh:
            self._fh.close()
        if self._wandb is not None:
            self._wandb.finish()


@contextlib.contextmanager
def trace(log_dir: Optional[str], enabled: bool = True) -> Iterator[None]:
    """A ``torch.profiler`` window (CPU, and CUDA where the card is) whose
    Chrome trace is written to ``<log_dir>/<host>_<pid>.<ns>.pt.trace.json``
    when the block ends; the card is synchronized before the window closes,
    so the block's kernels are all in it."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    logging.getLogger(__name__).info("profile written to %s", path)
