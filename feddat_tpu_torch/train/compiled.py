"""Steps and forwards as CUDA graphs: the port's counterpart of ``jax.jit``.

The JAX package runs every train step, eval step and serving forward as one
compiled program (``feddat_tpu/train/dat.py:307``, ``train/evaluation.py:41``,
``serving.py:171``).  Here a :class:`Compiled` function has three parts:

* a host **prologue** that turns its arguments into a tree of tensors (dicts,
  lists and tuples of tensors; any other leaf is a static value that keys
  the cache) and the seeds of the dropout generators the body draws from.
  All host arithmetic happens here: the lr, Adam's bias corrections and the
  stage seeds enter the body as device tensors and generator states;
* a device **body** ``body(inputs, gens) -> outputs`` that reads nothing from
  the host (no ``.item()``, ``float()``, ``tolist()``, ``.cpu()``, no
  tensor-valued ``if``, no generator made inside);
* a host **epilogue** that builds the result from the host part and the
  body's outputs.

The body runs in a :class:`Program`, which keeps one entry per input
signature (the tree's structure, each tensor's shape, dtype and device, and
the static leaves).  On the card an entry is a ``torch.cuda.CUDAGraph``: at
the first call of a signature one warm-up call runs on a side stream (it
builds every kernel through ``ops/_build.py`` and runs each wrapper's
one-time host setup), then the body is captured and the graph replayed;
later calls only replay it.  Every failure to capture or replay raises.

* **Inputs** are copied into static buffers at every call, one per (tree
  path, shape, dtype, device) of a program, shared by its entries (a graph
  reads them only while it replays, right after its own copies): those on
  the card in one multi-tensor copy, a CPU tensor in a call that has CUDA
  tensors one by one onto their device.
* **Outputs** are handed back as JAX's engine gets them without donation
  (``feddat_tpu/federated/engine.py:153-260``): an output that is an input
  passed through is the caller's own tensor, every other one a copy of the
  graph's output, so the inputs (resident ones aside) and the earlier
  results stay valid.
* **Resident inputs** (``resident``: the top-level keys of the input tree so
  marked, ALBEF's momentum twin under ``"aux"``) are donated, as
  ``jax.jit(..., donate_argnums=...)`` donates, with graphs on or off: a
  resident input that the program handed back is updated in place and
  handed back again (an earlier result that holds it sees the update); any
  other is copied first and never written.  With graphs the tensors handed
  back are the static buffers (on the card and in the CPU's plumbing
  alike), so a call that passes them in again copies nothing; eagerly
  (:func:`disable_graphs`) they are the copies the last eager call updated.
  After the warm-up call of a capture the buffers are filled again (from a
  snapshot when the caller passed the buffers themselves).  A resident dict
  comes back as a :class:`ResidentDict` tagged with the program's call
  count: passing one that an earlier call handed back, after a later call
  has updated its tensors in place, raises, as JAX raises on a donated
  buffer used again.
* **Generators**: an entry owns one ``torch.Generator`` per stage, registered
  with its graph and seeded from the prologue's seeds before every replay,
  so the masks are a function of the step's seed, as in eager mode.
* **Launch counts**: a launch recorded at capture does not run, and the
  warm-up call is part of building the graph, as a compile is of a jitted
  call: the capture takes both back from each ``CudaKernel``'s count, and
  every replay adds one call's launches.  So a count says how many launches
  the calls a caller made ran, as in eager mode.
* **Remat** (``ops/remat_policy.py``): a body with recomputed regions is
  captured as any other.  The recompute runs inside the captured backward;
  the checkpoint machinery adds host bookkeeping only (its one tensor is an
  empty CPU tensor), and a region reads its forward's dropout draws again,
  so a replay stays bitwise the eager step.
* **Other threads**: a capture holds :data:`capture_lock`; a thread that
  calls into CUDA while graphs may be captured (the batch prefetch) takes it
  around those calls.
* **Collectives**: a body that all-reduces over a ``torch.distributed``
  group (the SPMD engine's steps, every step and evaluation under tensor
  parallelism) is captured with the rest of it, NCCL's launches included.
  While a process group exists, every capture runs in the "thread_local"
  mode (:func:`capture_mode`): the group's watchdog thread calls into CUDA
  (it queries its events) at any time, a body without collectives's
  capture included, and that mode confines the capture's rules to the
  capturing thread.  An entry's key holds its inputs' shapes, so a graph
  replays only for parameters of the layout it was captured on: a rank's
  tensor-parallel shards run only under the model group that cut them
  (``parallel/tp.py``), and whole parameters never do.
* **Memory**: every graph allocates from one pool
  (``torch.cuda.graph_pool_handle()``); the graphs never run concurrently and
  their outputs are copied out before another graph replays.

On the CPU the same plumbing (prologue, static buffers, device-tensor
scalars, hand-back) runs the body eagerly, so the CPU tests exercise it.
:func:`disable_graphs`, the counterpart of ``jax.disable_jit``, calls the
prologue, the body on the caller's tensors and the epilogue directly, on any
device; it is the only switch.  :data:`STATS` counts captures, replays and
eager runs.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, Hashable, Iterator, List, Optional, Sequence, Tuple

import torch

from feddat_tpu_torch.ops._build import KERNELS
from feddat_tpu_torch.utils.seeding import stage_generator

_ENABLED = True
STATS = {"captures": 0, "replays": 0, "eager": 0}
_POOL = None
_STREAM = None
# held for the length of every capture: another thread that calls into CUDA
# (``data/pipeline.py::prefetch_to_device``'s producer pinning memory,
# allocating and copying) takes it first, so no such call falls inside a
# capture, which the default "global" capture mode refuses
capture_lock = threading.Lock()


@contextlib.contextmanager
def disable_graphs() -> Iterator[None]:
    """Run every :class:`Compiled` function inside the block eagerly, on the
    caller's tensors (``jax.disable_jit``)."""
    global _ENABLED
    prev, _ENABLED = _ENABLED, False
    try:
        yield
    finally:
        _ENABLED = prev


def _flatten(tree, path: tuple, leaves: List[torch.Tensor], paths: List[tuple]) -> Hashable:
    """-> a hashable structure of ``tree``; its tensors go to ``leaves`` (with
    their tree paths to ``paths``), dicts in key order."""
    if isinstance(tree, dict):
        return ("d", tuple((k, _flatten(tree[k], path + (k,), leaves, paths))
                           for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return ("l" if isinstance(tree, list) else "t",
                tuple(_flatten(v, path + (i,), leaves, paths) for i, v in enumerate(tree)))
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        paths.append(path)
        return ("T", tuple(tree.shape), tree.dtype, tree.device)
    return ("S", tree)


def _unflatten(struct, leaves: Iterator[torch.Tensor]):
    kind, body = struct[0], struct[1]
    if kind == "d":
        return {k: _unflatten(s, leaves) for k, s in body}
    if kind in ("l", "t"):
        items = [_unflatten(s, leaves) for s in body]
        return items if kind == "l" else tuple(items)
    if kind == "T":
        return next(leaves)
    return body


def _fill(bufs: Sequence[torch.Tensor], srcs: Sequence[torch.Tensor]) -> None:
    """Copy every input into its static buffer: the ones already on the
    buffers' device in one multi-tensor copy per dtype (a few launches for a
    thousand parameters), the others (a batch from the host) one by one; a
    buffer passed in as itself (a resident result) is not copied."""
    groups: Dict[torch.dtype, Tuple[List[torch.Tensor], List[torch.Tensor]]] = {}
    for b, t in zip(bufs, srcs):
        if t is b:
            continue
        if t.device == b.device:
            dst, src = groups.setdefault(b.dtype, ([], []))
            dst.append(b)
            src.append(t.detach())
        else:
            b.copy_(t.detach(), non_blocking=True)
    for dst, src in groups.values():
        torch._foreach_copy_(dst, src)


def _counts() -> List[int]:
    return [k.launches for k in KERNELS]


def _seed(gens: Sequence[torch.Generator], seeds: Sequence[int]) -> None:
    for g, s in zip(gens, seeds):
        g.manual_seed(s)


def _graph_device(leaves: Sequence[torch.Tensor]) -> torch.device:
    return next((t.device for t in leaves if t.is_cuda), torch.device("cpu"))


class ResidentDict(dict):
    """A resident subtree as a program handed it back, with the program's
    call count at that time (its generation)."""

    __slots__ = ("program", "generation")


def _tag_resident(tree, ids, program: "Program"):
    """``tree`` with every dict whose tensors are all in ``ids`` (the resident
    tensors of the call) made a :class:`ResidentDict` of this generation."""
    if isinstance(tree, dict):
        if tree and all(isinstance(v, torch.Tensor) and id(v) in ids for v in tree.values()):
            out = ResidentDict(tree)
            out.program, out.generation = program, program.generation
            return out
        return {k: _tag_resident(v, ids, program) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tag_resident(v, ids, program) for v in tree)
    return tree


class _Entry:
    """One input signature of a program: its static buffers, generators and,
    on the card, its graph, static outputs and launch counts per replay."""

    def __init__(self, struct, bufs: List[torch.Tensor], gens: List[torch.Generator],
                 resident: List[bool]):
        self.bufs = bufs
        self.gens = gens
        self.inputs = _unflatten(struct, iter(bufs))
        self.by_buffer = {id(b): i for i, b in enumerate(bufs)}
        self.resident = resident
        self.graph = None
        self.out_struct = None
        self.out_leaves: List[torch.Tensor] = []
        self.launches: List[Tuple[Any, int]] = []


def capture_mode() -> str:
    """The capture's error mode: "thread_local" while a process group
    exists (its watchdog thread calls into CUDA), else "global" (module
    docstring)."""
    live = torch.distributed.is_available() and torch.distributed.is_initialized()
    return "thread_local" if live else "global"


class Program:
    """``body(inputs, gens) -> outputs``, run from static buffers: replayed as a
    CUDA graph on the card, eagerly on the CPU (module docstring)."""

    def __init__(self, body: Callable, name: str, resident: Sequence[str] = ()):
        self.body = body
        self.name = name
        self.resident = frozenset(resident)
        self.entries: Dict[Hashable, _Entry] = {}
        self.bufs: Dict[tuple, torch.Tensor] = {}
        # the resident tensors the last eager call updated, by id
        self.eager_resident: Dict[int, torch.Tensor] = {}
        # calls that handed back resident tensors
        self.generation = 0

    def _buf(self, path: tuple, t: torch.Tensor, device: torch.device) -> torch.Tensor:
        """The static buffer of one input: a normal tensor even when it is
        made inside ``torch.inference_mode()``, so that calls inside and
        outside that mode can fill it."""
        key = (path, tuple(t.shape), t.dtype, device)
        if key not in self.bufs:
            with torch.inference_mode(False):
                self.bufs[key] = torch.empty(t.shape, dtype=t.dtype, device=device)
        return self.bufs[key]

    def eager(self, inputs, seeds: Sequence[int] = ()):
        """The body on the caller's tensors (CPU tensors staged onto the
        device of the CUDA ones) with fresh generators; a resident input that
        the last eager call did not update is copied first."""
        leaves: List[torch.Tensor] = []
        paths: List[tuple] = []
        struct = _flatten(inputs, (), leaves, paths)
        device = _graph_device(leaves)
        moved = [t.to(device) for t in leaves]
        resident = [p[0] in self.resident for p in paths]
        moved = [t.clone() if r and t is s and self.eager_resident.get(id(t)) is not t else t
                 for t, s, r in zip(moved, leaves, resident)]
        self.eager_resident = {id(t): t for t, r in zip(moved, resident) if r}
        STATS["eager"] += 1
        out = self.body(_unflatten(struct, iter(moved)), [stage_generator(s, device) for s in seeds])
        return self._next_generation(out, self.eager_resident)

    def _check_fresh(self, inputs) -> None:
        """Raise on a resident input that an earlier call of this program
        handed back: a later call has updated its tensors in place since."""
        for key in self.resident if isinstance(inputs, dict) else ():
            held = inputs.get(key)
            if (isinstance(held, ResidentDict) and held.program is self
                    and held.generation != self.generation):
                raise RuntimeError(
                    f"{self.name}: resident input {key!r} of call {held.generation} passed again "
                    f"after call {self.generation} updated its tensors in place (a donated "
                    "buffer used again); pass the state the last call returned")

    def _next_generation(self, out, resident_ids):
        if not self.resident:
            return out
        self.generation += 1
        return _tag_resident(out, resident_ids, self)

    def __call__(self, inputs, seeds: Sequence[int] = ()):
        self._check_fresh(inputs)
        if not _ENABLED:
            return self.eager(inputs, seeds)
        leaves: List[torch.Tensor] = []
        paths: List[tuple] = []
        struct = _flatten(inputs, (), leaves, paths)
        device = _graph_device(leaves)
        key = (struct, len(seeds))
        entry = self.entries.get(key)
        if entry is None:
            bufs = [self._buf(p, t, device) for p, t in zip(paths, leaves)]
            entry = _Entry(struct, bufs, [torch.Generator(device=device) for _ in seeds],
                           [p[0] in self.resident for p in paths])
            self.entries[key] = entry
        _fill(entry.bufs, leaves)
        if device.type != "cuda":
            _seed(entry.gens, seeds)
            STATS["eager"] += 1
            out_leaves: List[torch.Tensor] = []
            out_struct = _flatten(self.body(entry.inputs, entry.gens), (), out_leaves, [])
            return self._hand_back(entry, out_struct, out_leaves, leaves)
        if entry.graph is None:
            self._capture(entry, seeds, leaves)
        _seed(entry.gens, seeds)
        entry.graph.replay()
        STATS["replays"] += 1
        for kernel, n in entry.launches:
            kernel.launches += n
        return self._hand_back(entry, entry.out_struct, entry.out_leaves, leaves)

    def _hand_back(self, entry: _Entry, struct, out_leaves, leaves):
        """Outputs that are static input buffers -> the caller's tensors, or
        the buffers themselves where the input is resident; every other
        output -> a copy."""
        picked, resident_ids = [], set()
        for t in out_leaves:
            i = entry.by_buffer.get(id(t))
            if i is None:
                picked.append(t.clone())
            elif entry.resident[i]:
                picked.append(entry.bufs[i])
                resident_ids.add(id(entry.bufs[i]))
            else:
                picked.append(leaves[i])
        return self._next_generation(_unflatten(struct, iter(picked)), resident_ids)

    def _capture(self, entry: _Entry, seeds: Sequence[int], leaves: Sequence[torch.Tensor]) -> None:
        global _POOL, _STREAM
        if _POOL is None:
            _POOL, _STREAM = torch.cuda.graph_pool_handle(), torch.cuda.Stream()
        graph = torch.cuda.CUDAGraph()
        if entry.gens:
            register = getattr(graph, "register_generator_state", None)
            if register is None:
                raise RuntimeError(
                    f"{self.name}: torch {torch.__version__} has no "
                    "CUDAGraph.register_generator_state, so a body that draws dropout masks "
                    "from its own generators cannot be captured")
            for g in entry.gens:
                register(g)
        before = _counts()
        # warm-up: builds the kernels and runs their one-time host setup.  The
        # body may update the resident buffers: refill them afterwards from
        # the caller's tensors, or from a snapshot where the caller passed the
        # buffers themselves
        resident = [(b, t if t is not b else b.clone())
                    for b, t, r in zip(entry.bufs, leaves, entry.resident) if r]
        _STREAM.wait_stream(torch.cuda.current_stream())
        _seed(entry.gens, seeds)
        with torch.cuda.stream(_STREAM):
            self.body(entry.inputs, entry.gens)
        torch.cuda.current_stream().wait_stream(_STREAM)
        _fill([b for b, _ in resident], [t for _, t in resident])
        del resident
        warm = _counts()
        _seed(entry.gens, seeds)
        with capture_lock, torch.cuda.graph(graph, pool=_POOL, stream=_STREAM,
                                            capture_error_mode=capture_mode()):
            out = self.body(entry.inputs, entry.gens)
        after = _counts()
        entry.launches = [(k, a - w) for k, a, w in zip(KERNELS, after, warm) if a != w]
        for kernel, a, b in zip(KERNELS, after, before):
            kernel.launches -= a - b
        out_leaves: List[torch.Tensor] = []
        entry.out_struct = _flatten(out, (), out_leaves, [])
        entry.out_leaves = out_leaves
        entry.graph = graph
        STATS["captures"] += 1


class Compiled:
    """``prologue(*args, **kwargs) -> (inputs, seeds, host)``, then
    ``program(inputs, seeds) -> outputs``, then ``epilogue(host, outputs)``.
    Without an epilogue the outputs are the result.  ``key``, where the
    maker gives one, names the function the body computes (two makers that
    give equal keys build interchangeable bodies).  ``resident`` names the
    top-level input keys that are donated (module docstring)."""

    def __init__(self, body: Callable, prologue: Callable, epilogue: Optional[Callable] = None,
                 name: str = "compiled", key: Optional[Hashable] = None,
                 resident: Sequence[str] = ()):
        self.program = Program(body, name, resident)
        self.prologue = prologue
        self.epilogue = epilogue
        self.key = key

    def __call__(self, *args, **kwargs):
        inputs, seeds, host = self.prologue(*args, **kwargs)
        out = self.program(inputs, seeds)
        return out if self.epilogue is None else self.epilogue(host, out)

    def share(self, programs: Dict[Hashable, Program], key: Hashable) -> "Compiled":
        """Run the program registered under ``key`` (this one's if none is):
        callers whose bodies compute the same function of their inputs (the
        same model, partition names and optimizer settings) share its graphs."""
        self.program = programs.setdefault(key, self.program)
        return self
