"""Tensor parallelism over a ``model`` axis of ranks (counterpart of
``feddat_tpu/parallel/tp.py``).

The JAX package shards the frozen backbone Megatron-style by placement alone
and lets GSPMD insert the collectives.  Here each rank of a model group holds
plain local shards of the same tensors and the layers run the Megatron
pattern explicitly on them (``models/layers.py``, ``models/xbert.py``), so
``functional_call``, the casts at use and the CUDA-graph capture of a step
keep working on ordinary tensors.  The layout is JAX's, per layer of every
stack (ViLT, ViLT-BERT's text BERT, ALBEF's ViT, text, fusion and decoder
towers):

  * q/k/v projections and the FFN ``intermediate``: COLUMN-parallel, each
    rank holds ``1/M`` of the output features (its heads; flax kernels are
    ``[in, out]``, torch weights ``[out, in]``, so torch dim 0);
  * the attention ``out`` projection and the FFN ``output``: ROW-parallel,
    ``1/M`` of the input features (torch dim 1);
  * everything else — embeddings, LayerNorms, adapters, LoRA, prompts, heads,
    the pooler, and EVERY bias — replicated: in ``PEFTMode.BIAS`` the biases
    are the trainable partition, and trainable partitions are never sharded.

The collectives are four autograd ops over the model group:

  * :func:`copy_to_model` — identity forward, sum over the group backward;
    before each column-parallel projection (on ``x``, and on
    cross-attention's ``kv``);
  * :func:`reduce_from_model` — sum forward, identity backward; after each
    row-parallel projection, on its fp32 partial products (:func:`row`
    casts the sum at the usual rounding point and then adds the replicated
    bias, as flax's ``Dense`` rounds);
  * :func:`take_local` — this rank's columns of a replicated tensor (the
    q/k/v/intermediate biases, LoRA's ``x·A·B``); its backward scatters into
    zeros and sums over the group, so a replicated trainable's gradient is
    whole and equal on every model rank.

Sums over the group run in fp32.  Every model rank of a slot sees the same
rows and the same generators, so dropout draws the full-size mask and keeps
its own slice (attention probabilities) or the whole of it (hidden states
after a reduce): tp = M computes what tp = 1 computes.  No kernel route
partitions over the model axis, as in JAX (``cli.py::apply_tp_arg_guards``
moves them to ``"auto"``): the engines and :func:`tp_forward` refuse a
model with one (:func:`check_model`).

A layer finds the group through :func:`current`, the context that
:func:`active` opens around a step or an evaluation.  With none (``tp``
None) every op here is the plain one (``dense``, the identity, every head
local), so the layers run one body with or without tensor parallelism.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F

from feddat_tpu_torch.models.adapters import dense
from feddat_tpu_torch.ops.remat_policy import checkpoint_name
from feddat_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, RankMesh, _every_rank_has_a_slot

# matched against the JAX form of a name (``a/b/kernel``), as JAX matches
# the last components of each flattened path
_COLUMN_KERNELS = ("query/dense/kernel", "key/kernel", "key/dense/kernel",
                   "value/dense/kernel", "intermediate/kernel")
_ROW_KERNELS = ("out/kernel", "output/kernel")
# the routes whose kernels hold whole weights: no kernel partitions over the model axis
COMPOSABLE_ROUTES = ("auto", "xla")


def _jax_path(name: str, tensor: torch.Tensor) -> str:
    """``a.b.weight`` of a 2-D weight -> ``a/b/kernel`` (flax's name)."""
    parts = name.split(".")
    if parts[-1] == "weight" and tensor.dim() == 2:
        parts[-1] = "kernel"
    return "/".join(parts)


def tp_spec_for(name: str, tensor: torch.Tensor) -> Optional[int]:
    """The torch dim of ``tensor`` sharded over the ``model`` axis, or None
    (replicated): JAX's ``tp_spec_for`` on the port's names, its kernel axes
    transposed."""
    j = _jax_path(name, tensor)
    if "adapter" in j or "lora" in j or "prompt" in j or "task_" in j or "/cls/" in f"/{j}/":
        return None
    if any(j.endswith(s) for s in _COLUMN_KERNELS):
        return 0  # output features
    if any(j.endswith(s) for s in _ROW_KERNELS) and tensor.dim() >= 2:
        return 1  # input features
    return None


@dataclasses.dataclass(frozen=True)
class TPContext:
    """This rank's model group: its collective group, its index and size."""

    group: object
    rank: int
    size: int


def context(mesh: RankMesh) -> Optional[TPContext]:
    """The mesh's model group as a context, or None without a model axis > 1."""
    m = mesh.size(MODEL_AXIS)
    return TPContext(mesh.model_group, mesh.model_index, m) if m > 1 else None


_ACTIVE: Optional[TPContext] = None


@contextlib.contextmanager
def active(ctx: Optional[TPContext]) -> Iterator[None]:
    """Make ``ctx`` the context the layers read inside the block (None: no
    tensor parallelism).  A process-wide setting, not a thread-local one: a
    recompute in the backward reads it from the autograd thread."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, ctx
    try:
        yield
    finally:
        _ACTIVE = prev


def current() -> Optional[TPContext]:
    return _ACTIVE


def tp_grid(model_parallel: int, data_parallel: Optional[int] = None,
            world_size: Optional[int] = None) -> np.ndarray:
    """JAX's ``make_tp_mesh`` arithmetic on ranks -> the ``[D, M]`` grid
    (``data_parallel`` defaults to the rest of the world), with its errors
    word for word; as in ``make_mesh``, every rank needs a slot."""
    n = dist.get_world_size() if world_size is None else world_size
    if data_parallel is None:
        if n % model_parallel != 0:
            raise ValueError(f"{n} devices not divisible by model={model_parallel}")
        data_parallel = n // model_parallel
    need = data_parallel * model_parallel
    if need > n:
        raise ValueError(f"need {need} devices, have {n}")
    _every_rank_has_a_slot(need, n, (data_parallel, model_parallel))
    return np.arange(need).reshape(data_parallel, model_parallel)


def make_tp_mesh(model_parallel: int, data_parallel: Optional[int] = None,
                 device_type: str = "cuda") -> RankMesh:
    """The ``(data, model)`` mesh over the initialised world
    (:func:`tp_grid`'s errors first)."""
    return RankMesh(tp_grid(model_parallel, data_parallel), device_type,
                    names=(DATA_AXIS, MODEL_AXIS))


def _local(t: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    if t.shape[dim] % size:
        raise ValueError(f"dim {dim} of a {tuple(t.shape)} tensor is not divisible by model={size}")
    n = t.shape[dim] // size
    return t.narrow(dim, rank * n, n)


def shard_params_tp(params: Dict[str, torch.Tensor], ctx: Optional[TPContext]
                    ) -> Dict[str, torch.Tensor]:
    """A full ``{name: tensor}`` dict -> this rank's: each tensor that
    :func:`tp_spec_for` shards cut to its slice (a copy, so the whole tensor
    is not kept alive), the rest as they are.  ``ctx`` None returns ``params``."""
    if ctx is None:
        return params
    out = {}
    for k, v in params.items():
        dim = tp_spec_for(k, v)
        out[k] = (v if dim is None
                  else _local(v, dim, ctx.rank, ctx.size).clone(memory_format=torch.contiguous_format))
    return out


def gather_params_tp(params: Dict[str, torch.Tensor], ctx: Optional[TPContext]
                     ) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`shard_params_tp` (a collective over the model
    group): every sharded tensor whole again on every model rank, bitwise,
    by one all-reduce of the zero-filled full tensors (any backend takes it,
    gloo on CUDA tensors included)."""
    if ctx is None:
        return params
    names = [k for k, v in params.items() if tp_spec_for(k, v) is not None]
    out = dict(params)
    for dtype in sorted({params[k].dtype for k in names}, key=str):
        group = [k for k in names if params[k].dtype == dtype]
        fulls = []
        for k in group:
            v, dim = params[k], tp_spec_for(k, params[k])
            shape = list(v.shape)
            shape[dim] *= ctx.size
            full = v.new_zeros(shape)
            full.narrow(dim, ctx.rank * v.shape[dim], v.shape[dim]).copy_(v)
            fulls.append(full)
        flat = torch.cat([f.reshape(-1) for f in fulls])
        dist.all_reduce(flat, group=ctx.group)
        i = 0
        for k, f in zip(group, fulls):
            out[k] = flat[i:i + f.numel()].view(f.shape).clone()
            i += f.numel()
    return out


def _sum_f32(t: torch.Tensor, group) -> torch.Tensor:
    s = t.to(torch.float32).contiguous().clone()
    dist.all_reduce(s, group=group)
    return s


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_f32(g, ctx.group).to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_f32(x, group).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _TakeLocal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp, ctx.shape = dim, tp, x.shape
        return _local(x, dim, tp.rank, tp.size).clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape, dtype=torch.float32)
        full.narrow(ctx.dim, ctx.tp.rank * g.shape[ctx.dim], g.shape[ctx.dim]).copy_(g)
        dist.all_reduce(full, group=ctx.tp.group)
        return full.to(g.dtype), None, None


class _MatmulF32(torch.autograd.Function):
    """``x @ w.T`` of ``dtype`` operands with an fp32 result; the backward
    takes the gradient in the operands' dtype, as ``F.linear``'s would."""

    @staticmethod
    def forward(ctx, x, w):
        from feddat_tpu_torch.ops.layer_block import mm_f32

        ctx.save_for_backward(x, w)
        return mm_f32(x, w.t())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gx = g @ w if ctx.needs_input_grad[0] else None
        gw = (g.reshape(-1, g.shape[-1]).t() @ x.reshape(-1, x.shape[-1])
              if ctx.needs_input_grad[1] else None)
        return gx, gw


def copy_to_model(x: torch.Tensor, tp: Optional[TPContext]) -> torch.Tensor:
    return x if tp is None else _CopyToModel.apply(x, tp.group)


def reduce_from_model(x: torch.Tensor, tp: Optional[TPContext]) -> torch.Tensor:
    return x if tp is None else _ReduceFromModel.apply(x, tp.group)


def take_local(x: torch.Tensor, tp: Optional[TPContext], dim: int = -1) -> torch.Tensor:
    return x if tp is None else _TakeLocal.apply(x, dim % x.dim(), tp)


def local_heads(num_heads: int, tp: Optional[TPContext]) -> Optional[tuple]:
    """``(first, total)`` of this rank's heads for ``dot_product_attention``
    (None: every head is local)."""
    return None if tp is None else (tp.rank * (num_heads // tp.size), num_heads)


def column(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype, tp: Optional[TPContext],
           tag: Optional[str] = None) -> torch.Tensor:
    """A column-parallel ``dense`` on ``x`` (already through
    :func:`copy_to_model`): the local weight rows and this rank's slice of
    the replicated bias -> this rank's output features in ``dtype``.
    ``tp`` None: ``dense`` itself."""
    if tp is None:
        return dense(x, layer, dtype, tag)
    b = None if layer.bias is None else take_local(layer.bias, tp, 0).to(dtype)
    x, w = x.to(dtype), layer.weight.to(dtype)
    with checkpoint_name(tag):
        return F.linear(x, w, b)


def row(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype, tp: Optional[TPContext],
        tag: Optional[str] = None) -> torch.Tensor:
    """A row-parallel ``dense``: the fp32 partial product of this rank's input
    features (an input that does not come from a column-parallel layer
    takes its local slice first), summed over the group, cast to ``dtype``,
    plus the replicated bias.  ``tp`` None: ``dense`` itself."""
    if tp is None:
        return dense(x, layer, dtype, tag)
    w = layer.weight
    if x.shape[-1] != w.shape[1]:
        x = take_local(x, tp)
    y = reduce_from_model(_MatmulF32.apply(x.to(dtype), w.to(dtype)), tp)
    with checkpoint_name(tag):
        y = y.to(dtype)
    return y if layer.bias is None else y + layer.bias.to(dtype)


def check_model(model: nn.Module) -> None:
    """Refuse a model with a kernel route: no kernel partitions over the
    model axis (JAX's CLI moves every Pallas route to ``"auto"`` under
    ``--tp``)."""
    routes = sorted({m.attn_impl for m in model.modules()
                     if isinstance(getattr(m, "attn_impl", None), str)} - set(COMPOSABLE_ROUTES))
    if routes:
        raise ValueError(f"attn_impl {routes} launch kernels that hold whole weights and do not "
                         "partition over the model axis; tensor parallelism runs attn_impl='auto'")


def backbone_bytes(params: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """Bytes of ``params`` in the tensors :func:`tp_spec_for` shards and in all."""
    sharded = sum(v.numel() * v.element_size() for k, v in params.items()
                  if tp_spec_for(k, v) is not None)
    return {"sharded": sharded, "total": sum(v.numel() * v.element_size() for v in params.values())}


def tp_forward(model: nn.Module, mesh: RankMesh, task_key: Optional[str] = None):
    """The data + tensor parallel deterministic forward (JAX's ``tp_forward``):
    -> ``(fn, place_batch)``.  ``fn(params, batch)`` takes this rank's shards
    (:func:`shard_params_tp`) and its data rows, in the ensemble adapter
    mode, and returns the ViLT family's logits of those rows (``task_key``
    given) or ALBEF's loss averaged over the data group, the whole batch's
    as JAX's; ``place_batch`` cuts a whole batch to this rank's rows."""
    from feddat_tpu_torch.train.forwards import call_method

    check_model(model)
    ctx = context(mesh)
    d, n = mesh.data_index, mesh.size(DATA_AXIS)

    def place_batch(batch):
        return {k: _local(torch.as_tensor(v), 0, d, n) for k, v in batch.items()}

    @torch.no_grad()
    def fn(params, batch):
        with active(ctx):
            if task_key is not None:
                return call_method(model, params, "forward", task_key, batch,
                                   adapter_mode="ensemble", deterministic=True)[1]
            loss = call_method(model, params, "forward", batch, adapter_mode="ensemble",
                               deterministic=True)[0]
        if n > 1:
            loss = _sum_f32(loss, mesh.data_group) / n
        return loss

    return fn, place_batch
