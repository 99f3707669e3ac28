"""Graceful preemption (copy of ``GracefulPreemption`` in
``feddat_tpu/utils/preemption.py``).

A machine that is about to be reclaimed sends SIGTERM and gives a grace
window.  The engine finishes the round in flight, writes its checkpoint and
returns instead of dying mid-update; the next launch resumes from the
checkpoint directory::

    with GracefulPreemption() as stop:
        for r in rounds:
            run_round(r); save_checkpoint(r)
            if stop.requested:
                break

The SPMD engine (``federated/spmd.py``) runs one process per device: every
rank asks :meth:`GracefulPreemption.any_process_requested`, a collective,
at the same round boundary, so that all of them leave the round loop
together.
"""

from __future__ import annotations

import logging
import signal
import threading

logger = logging.getLogger("feddat_tpu_torch")


class GracefulPreemption:
    """Context manager that latches SIGTERM (and optionally others) into a
    flag instead of killing the process.  Handlers are installed on enter and
    the previous ones restored on exit; a second signal while latched still
    only sets the flag.  A no-op (the flag stays False, no handler touched)
    when ``enabled`` is False or outside the main thread (CPython allows
    ``signal.signal`` only there)."""

    def __init__(self, enabled: bool = True, signals=(signal.SIGTERM,)):
        self.enabled = enabled
        self.signals = tuple(signals)
        self._prev = {}
        self.requested = False

    def _handler(self, signum, frame):
        if not self.requested:
            logger.warning("signal %s received: finishing the current round, checkpointing, "
                           "then exiting cleanly", signal.Signals(signum).name)
        self.requested = True

    def __enter__(self):
        if self.enabled and threading.current_thread() is threading.main_thread():
            for s in self.signals:
                self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()
        return False

    def any_process_requested(self) -> bool:
        """True when any rank of the initialised process group latched a
        signal: one all-reduce (MAX) of the local flag over the world, which
        every rank must call at the same point (a rank that left the round
        loop alone would leave the others waiting at their next collective).
        In a world of one, or with no group, just the local flag."""
        import torch
        import torch.distributed as dist

        if not dist.is_initialized() or dist.get_world_size() == 1:
            return self.requested
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
        flag = torch.tensor([1 if self.requested else 0], dtype=torch.int32, device=device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())
