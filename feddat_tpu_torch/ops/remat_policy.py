"""Remat policies: which tensors a recomputed region keeps.

Counterpart of ``feddat_tpu/ops/remat_policy.py``: :func:`resolve_remat_policy`
takes the same names, raises the same errors and gives None for a full
recompute.  JAX tags values (``checkpoint_name``) and ``jax.checkpoint`` keeps
the tagged ones; PyTorch's selective checkpointing
(``torch.utils.checkpoint.create_selective_checkpoint_contexts``) decides per
dispatched op whether its output is kept or run again in the backward.  So
here :func:`checkpoint_name` is a scope around the op that produces a tagged
tensor, and a :class:`Policy` keeps the ops run inside a scope whose names it
holds (``"dots"``: the matmul ops' outputs).  A scope names all of its op's
outputs: kernel #1's one op returns ``attn_out``, ``attn_ctx`` and
``attn_lse`` together (``ops/attn_block.py``).  Views and in-place ops are
never kept (a view is rebuilt from its kept base; a kept tensor that an
in-place op later changed makes the recompute raise).

:func:`remat` runs a module call as one non-reentrant checkpoint region
(:func:`remat_call` is the encoders' switch around it):

* every policy, ``"full"`` included, keeps the region's random draws (ops
  tagged ``nondeterministic_seeded``): the dropout masks, each drawn as a
  bool tensor by one op (``utils/seeding.py::keep_mask``), one byte per
  element as the path without remat keeps them.  The recompute reads them
  and never draws.  JAX keeps none and draws them again from the key; here
  that would need the explicit generator that ``dropout_rng`` makes current
  (which ``preserve_rng_state`` does not restore) rewound to the region's
  entry inside a CUDA-graph capture too, where ``Generator.clone_state``
  raises and ``graphsafe_get_state`` hands back the live state, not a copy;
* the recompute runs with the generator that was current at the region's
  entry (``keep_mask`` refuses to run without one) and with the module's
  parameters as they were at entry: a step calls the model through
  ``torch.func.functional_call``, which has put the module's own parameters
  back by the time the backward recomputes.

The structural names ``attention`` and ``min_save`` are handled by the layer
(``models/layers.py::PreLNLayer``), as in JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import FrozenSet, Iterator, List, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from feddat_tpu_torch.utils import seeding

_STRUCTURAL = ("attention", "min_save")
_aten = torch.ops.aten
# ``jax.checkpoint_policies.dots_saveable``: the outputs of the matmul ops
DOT_OPS = frozenset({_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
                     _aten.baddbmm.default})

_SCOPES: List[FrozenSet[str]] = []


@contextlib.contextmanager
def checkpoint_name(*names: Optional[str]) -> Iterator[None]:
    """``jax.ad_checkpoint.checkpoint_name``: the ops run inside the block
    produce the tensors ``names``; a policy that holds every one of them keeps
    those ops' outputs.  No names (or only None): no scope."""
    names = tuple(n for n in names if n)
    if not names:
        yield
        return
    _SCOPES.append(frozenset(names))
    try:
        yield
    finally:
        _SCOPES.pop()


def active_names() -> FrozenSet[str]:
    """The names of the innermost :func:`checkpoint_name` scope (empty outside one)."""
    return _SCOPES[-1] if _SCOPES else frozenset()


@dataclasses.dataclass(frozen=True)
class Policy:
    """A selective-checkpoint policy function: keep the random draws (bool
    masks), the ops
    of a tag scope whose names are all in ``names``, and, with ``dots``, the
    matmul ops; run everything else again.  It reads only the op and the
    scopes, so the forward and the recompute decide alike."""

    names: FrozenSet[str] = frozenset()
    dots: bool = False

    def __call__(self, ctx, op, *args, **kwargs) -> CheckpointPolicy:
        schema = op._schema
        if torch.Tag.nondeterministic_seeded in op.tags:
            if schema.is_mutable:
                raise RuntimeError(f"remat: in-place random op {op} in a recomputed region; draw "
                                   "masks with an out-of-place op (utils/seeding.py::keep_mask)")
            return CheckpointPolicy.MUST_SAVE
        if schema.is_mutable or op.is_view:
            return CheckpointPolicy.PREFER_RECOMPUTE
        scope = active_names()
        if (scope and scope <= self.names) or (self.dots and op in DOT_OPS):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE


FULL = Policy()


def resolve_remat_policy(name: str, supports_structural: bool = True) -> Optional[Policy]:
    """The :class:`Policy` for ``name`` (None = save nothing, a full recompute)."""
    if name in ("full",) + (_STRUCTURAL if supports_structural else ()):
        return None
    if name == "dots":
        return Policy(dots=True)
    if name == "names":
        # the cheap-to-store, expensive-to-recompute tensors (models/layers.py,
        # ops/attention.py, models/xbert.py)
        return Policy(frozenset({"qkv", "attn_probs", "attn_out", "ffn_preact"}))
    if name == "block_save":
        return Policy(frozenset({"attn_x", "attn_ctx", "attn_lse", "attn_out"}))
    if name == "block_save_nox":
        # like block_save, the kernel's input rebuilt by the LayerNorm instead
        return Policy(frozenset({"attn_ctx", "attn_lse", "attn_out"}))
    if name == "block_save_ffn":
        return Policy(frozenset({"attn_x", "attn_ctx", "attn_lse", "attn_out", "ffn_preact"}))
    raise ValueError(
        f"unsupported remat_policy {name!r} for this layer stack"
        + ("" if supports_structural else f" (structural policies {_STRUCTURAL} are not wired here)")
    )


@contextlib.contextmanager
def _recompute(inner, gen: Optional[torch.Generator]) -> Iterator[None]:
    with seeding.dropout_rng(gen), inner:
        yield


def remat(module: torch.nn.Module, policy: Optional[Policy], *args, **kwargs):
    """``module(*args, **kwargs)`` as one recomputed region (``nn.remat`` with
    ``policy``; None recomputes all but the random draws).  Without grad mode
    (an eval forward) there is no backward to recompute for: a plain call."""
    if not torch.is_grad_enabled():
        return module(*args, **kwargs)
    # every name, also where a caller passes one tensor for two of them (the
    # engine's teacher adapter_2 starts as adapter_1's tensors): a name left
    # out would be recomputed with the module's own parameter
    names, tensors = [], []
    for name, t in [*module.named_parameters(remove_duplicate=False),
                    *module.named_buffers(remove_duplicate=False)]:
        names.append(name)
        tensors.append(t)
    gen = seeding.current_rng()
    n = len(names)

    def run(*flat):
        return torch.func.functional_call(module, dict(zip(names, flat[:n])), flat[n:], kwargs)

    def context_fn():
        fwd, rec = create_selective_checkpoint_contexts(policy or FULL)
        return fwd, _recompute(rec, gen)

    return checkpoint(run, *tensors, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=context_fn)


def remat_call(module: torch.nn.Module, enabled: bool, name: str, supports_structural: bool,
               *args, **kwargs):
    """``module(*args, **kwargs)``, as one :func:`remat` region with the policy
    ``name`` where ``enabled``.  The structural names are the layer's own
    flags (``PreLNLayer``'s ``remat_attention``/``remat_ln``), so where the
    stack supports them the call is plain; where it does not, they raise as
    in JAX."""
    if not enabled or (supports_structural and name in _STRUCTURAL):
        return module(*args, **kwargs)
    return remat(module, resolve_remat_policy(name, supports_structural), *args, **kwargs)
