"""Train steps: DAT + Mutual-KD (standard and fused), and the single-update step.

Counterpart of ``feddat_tpu/train/dat.py``.  The reference's DAT step
(``task_trainer.py:280-330``) is three forwards and two backward/AdamW steps
per batch:

  ① ensemble {adapter_0, adapter_2} forward, no grad -> logits_all
  ② adapter_1 forward; L1 = (task + KL(l1 ‖ logits_all))/2; update adapter_1 + head
  ③ ensemble forward; L0 = (task + KL(l0 ‖ l1))/2; update adapter_0 + head

Each step is a plain function ``step(state, batch) -> (state, metrics)``:
the trainable partitions are detached copies that require grad, passed into
the model with ``torch.func.functional_call``; the two updates share one
schedule clock (lr(c) then lr(c+1), c advances by 2) and the head's Adam
state advances in both, exactly as in JAX.  Each ``make_*`` builder
stands for the JAX ``*_step_core`` and the ``make_*`` that compiles it;
nothing is compiled here.  The metrics hold the losses, the lr and
``grads``: both updates' gradient sets (adapter and head partitions only).

Dropout: as JAX splits ``state.rng`` into per-stage keys, each step draws
per-stage seeds from a copy of ``state.rng`` (``utils/seeding.py::split_rng``;
the copy, advanced by the same draw every step, is the new state's ``rng``)
and makes one dropout generator per stage on the parameters' device: the
standard step d0 (①), d1 (②), d2 (③); the fused step d0 (the ensemble pass
that ① and ③ share) and d1 (the adapter_1 pass); the plain step one.  The
same state gives the same masks; ``torch.manual_seed`` changes nothing.
``TrainConfig.dropout_rng`` selects nothing here: "threefry" and "rbg" (the
TPU's hardware bit generator in JAX) give the same torch generators
(``utils/seeding.py::check_dropout_rng``).
"""

from __future__ import annotations

from typing import Any, Dict, FrozenSet, Tuple

import torch

from feddat_tpu_torch.configs.core import OptimizerConfig, PEFTMode
from feddat_tpu_torch.models.adapters import MODE_ENSEMBLE
from feddat_tpu_torch.peft.partition import (
    ROLE_HEAD,
    ROLE_LOCAL,
    ROLE_SHARED,
    label_params,
    trainable_roles,
)
from feddat_tpu_torch.train.losses import kd_kl_loss
from feddat_tpu_torch.train.optim import adamw_direction, apply_direction, polynomial_schedule
from feddat_tpu_torch.train.state import TrainState
from feddat_tpu_torch.utils.seeding import split_rng, stage_generator

Params = Dict[str, torch.Tensor]


def _stage_rngs(state: TrainState, n: int):
    """-> (the new state's rng, n per-stage dropout generators on the
    parameters' device)."""
    nxt, seeds = split_rng(state.rng, n)
    device = next(iter(state.params.values())).device
    return nxt, [stage_generator(s, device) for s in seeds]


def _in_frozen_bottom(name: str, layers_to_freeze: int) -> bool:
    """Under ``freeze_bottom_k_layers``: the embeddings and layers ``< k`` stay
    frozen (dat.py:106-152; ViLT's stack is ``vilt.layers.<i>``)."""
    parts = name.split(".")
    if any("embeddings" in part for part in parts):
        return True
    if "layers" in parts:
        return int(parts[parts.index("layers") + 1]) < layers_to_freeze
    return False


class Partitioner:
    """Static name-set partitioning of a parameter dict for one client.

    ``shared`` (adapter_1, or the mode's trainable non-head roles),
    ``local`` (adapter_0), ``head`` (the *active* task's head only — other
    clients' heads must not be touched by weight decay), frozen the rest.

    ``freeze_bottom_k_layers``: JAX keeps the stacked layers in the trainable
    set, masks the bottom ``layers_to_freeze`` layers' gradients to 0 and
    blends their decayed values back (dat.py:664-682); with one name per layer
    the port leaves those layers out of the trainable set, which yields the
    same parameters, and autograd then skips their backward altogether."""

    def __init__(self, params: Params, task_key: str, mode: PEFTMode, layers_to_freeze: int = 0):
        labels = label_params(params)
        self.mode = mode
        head_tag = f"task_{task_key}"
        self.head_paths: FrozenSet[str] = frozenset(
            n for n, l in labels.items()
            if l == ROLE_HEAD and (head_tag in n.split(".") or "cls" in n.split("."))
        )
        if mode == PEFTMode.DAT:
            self.shared_paths = frozenset(n for n, l in labels.items() if l == ROLE_SHARED)
            self.local_paths = frozenset(n for n, l in labels.items() if l == ROLE_LOCAL)
        else:
            roles = trainable_roles(mode) - {ROLE_HEAD}
            freeze = mode == PEFTMode.FREEZE_BOTTOM_K
            self.shared_paths = frozenset(
                n for n, l in labels.items()
                if l in roles and "text_bert" not in n.split(".")
                and not (freeze and _in_frozen_bottom(n, layers_to_freeze)))
            self.local_paths = frozenset()

    def extract(self, params: Params, paths: FrozenSet[str]) -> Params:
        return {n: params[n] for n in sorted(paths)}

    def merge_into(self, params: Params, sub: Params) -> Params:
        out = dict(params)
        out.update(sub)
        return out


def init_train_state(params: Params, partitioner: Partitioner, opt_cfg: OptimizerConfig,
                     rng: torch.Generator) -> TrainState:
    tx = adamw_direction(opt_cfg)
    P = partitioner
    if P.mode == PEFTMode.DAT:
        opt_states = {"shared": tx.init(P.extract(params, P.shared_paths)),
                      "local": tx.init(P.extract(params, P.local_paths)),
                      "head": tx.init(P.extract(params, P.head_paths))}
    else:
        opt_states = {"trainable": tx.init(P.extract(params, P.shared_paths | P.head_paths))}
    return TrainState(params=params, opt_states=opt_states, sched_count=0, rng=rng)


def _leaves(sub: Params) -> Params:
    return {k: v.detach().requires_grad_() for k, v in sub.items()}


def _grads(loss: torch.Tensor, *subs: Params) -> Tuple[Params, ...]:
    names = [list(s) for s in subs]
    flat = torch.autograd.grad(loss, [t for s in subs for t in s.values()])
    out, i = [], 0
    for ns in names:
        out.append(dict(zip(ns, flat[i:i + len(ns)])))
        i += len(ns)
    return tuple(out)


def _detached(sub: Params) -> Params:
    return {k: v.detach() for k, v in sub.items()}


def make_dat_train_step(forward, partitioner: Partitioner, opt_cfg: OptimizerConfig,
                        max_steps: int):
    """The standard DAT step (``dat_step_core``): ``forward(params, batch,
    adapter_mode, gen) -> (task_loss, logits)``, three forwards, two updates."""
    tx = adamw_direction(opt_cfg)
    lr_at = polynomial_schedule(opt_cfg, max_steps)
    P = partitioner

    def step(state: TrainState, batch: Dict[str, Any]):
        rng, (d0, d1, d2) = _stage_rngs(state, 3)
        params = state.params
        # ① ensemble forward (teacher + local mix), no gradient
        with torch.no_grad():
            _, logits_all = forward(params, batch, MODE_ENSEMBLE, d0)

        # ② shared-adapter update
        shared = _leaves(P.extract(params, P.shared_paths))
        head = _leaves(P.extract(params, P.head_paths))
        task_l1, logits_1 = forward(P.merge_into(P.merge_into(params, shared), head), batch,
                                    "adapter_1", d1)
        l1 = (task_l1 + kd_kl_loss(logits_1, logits_all)) / 2.0
        g_shared, g_head2 = _grads(l1, shared, head)
        lr1 = lr_at(state.sched_count)
        new_shared, opt_shared = apply_direction(tx, g_shared, state.opt_states["shared"],
                                                 _detached(shared), lr1)
        head, opt_head = apply_direction(tx, g_head2, state.opt_states["head"], _detached(head), lr1)
        params = P.merge_into(P.merge_into(params, new_shared), head)
        logits_1 = logits_1.detach()

        # ③ local-adapter update through the ensemble forward
        local = _leaves(P.extract(params, P.local_paths))
        head = _leaves(head)
        task_l0, logits_0 = forward(P.merge_into(P.merge_into(params, local), head), batch,
                                    MODE_ENSEMBLE, d2)
        l0 = (task_l0 + kd_kl_loss(logits_0, logits_1)) / 2.0
        g_local, g_head = _grads(l0, local, head)
        lr0 = lr_at(state.sched_count + 1)
        new_local, opt_local = apply_direction(tx, g_local, state.opt_states["local"],
                                               _detached(local), lr0)
        head, opt_head = apply_direction(tx, g_head, opt_head, _detached(head), lr0)
        params = P.merge_into(P.merge_into(params, new_local), head)

        new_state = state.replace(
            params=params, opt_states={"shared": opt_shared, "local": opt_local, "head": opt_head},
            sched_count=state.sched_count + 2, rng=rng)
        grads = {"shared": g_shared, "head_2": g_head2, "local": g_local, "head_3": g_head}
        return new_state, {"loss": l0.detach(), "loss_shared": l1.detach(),
                           "task_loss": task_l0.detach(), "lr": lr0, "grads": grads}

    return step


def make_dat_train_step_fused(encode_fn, head_fn, task_loss_fn, partitioner: Partitioner,
                              opt_cfg: OptimizerConfig, max_steps: int):
    """DAT step with ONE ensemble encoder pass (``dat_step_core_fused``,
    dat.py:311-415): between ① and ③ only the head changes, so the pass's
    pooled features give the teacher logits (old head) and its saved graph
    gives ③'s adapter_0 gradient (new head).  Exact against
    :func:`make_dat_train_step` when the encoder has no live dropout (ViLT;
    ALBEF with its rates set to 0).  With live dropout the encoder passes
    draw fresh masks every step, d0 for the ensemble pass and d1 for the
    adapter_1 pass; the one deviation from three independent forwards is
    that ① and ③ share d0's masks (``trainers.py::check_fused_dropout``).

    ``encode_fn(params, batch, mode, gen) -> pooled``, ``head_fn(head
    partition, pooled) -> logits``, ``task_loss_fn(logits, batch)``."""
    tx = adamw_direction(opt_cfg)
    lr_at = polynomial_schedule(opt_cfg, max_steps)
    P = partitioner

    def step(state: TrainState, batch: Dict[str, Any]):
        rng, (d0, d1) = _stage_rngs(state, 2)
        params = state.params
        head = P.extract(params, P.head_paths)
        local = _leaves(P.extract(params, P.local_paths))
        shared = P.extract(params, P.shared_paths)

        # one ensemble encoder pass, differentiable with respect to adapter_0
        pooled = encode_fn(P.merge_into(params, local), batch, MODE_ENSEMBLE, d0)
        with torch.no_grad():
            logits_all = head_fn(head, pooled.detach())

        # ② shared-adapter update (full forward through adapter_1)
        shared_l, head_l = _leaves(shared), _leaves(head)
        pooled1 = encode_fn(P.merge_into(params, shared_l), batch, "adapter_1", d1)
        logits = head_fn(head_l, pooled1)
        l1 = (task_loss_fn(logits, batch) + kd_kl_loss(logits, logits_all)) / 2.0
        g_shared, g_head2 = _grads(l1, shared_l, head_l)
        lr1 = lr_at(state.sched_count)
        new_shared, opt_shared = apply_direction(tx, g_shared, state.opt_states["shared"], shared, lr1)
        head, opt_head = apply_direction(tx, g_head2, state.opt_states["head"], head, lr1)
        params = P.merge_into(P.merge_into(params, new_shared), head)
        logits_1 = logits.detach()

        # ③ local update: the new head on the saved pooled, back through the saved graph
        head_l = _leaves(head)
        logits = head_fn(head_l, pooled)
        l0 = (task_loss_fn(logits, batch) + kd_kl_loss(logits, logits_1)) / 2.0
        g_head, g_local = _grads(l0, head_l, local)
        lr0 = lr_at(state.sched_count + 1)
        new_local, opt_local = apply_direction(tx, g_local, state.opt_states["local"],
                                               _detached(local), lr0)
        head, opt_head = apply_direction(tx, g_head, opt_head, head, lr0)
        params = P.merge_into(P.merge_into(params, new_local), head)

        new_state = state.replace(
            params=params, opt_states={"shared": opt_shared, "local": opt_local, "head": opt_head},
            sched_count=state.sched_count + 2, rng=rng)
        grads = {"shared": g_shared, "head_2": g_head2, "local": g_local, "head_3": g_head}
        return new_state, {"loss": l0.detach(), "loss_shared": l1.detach(), "lr": lr0,
                           "grads": grads}

    return step


def make_plain_train_step(forward, partitioner: Partitioner, opt_cfg: OptimizerConfig,
                          max_steps: int, adapter_mode: str = "none"):
    """One forward/backward/update for the non-DAT modes (``plain_step_core``,
    ``task_trainer.py:433-450``)."""
    tx = adamw_direction(opt_cfg)
    lr_at = polynomial_schedule(opt_cfg, max_steps)
    P = partitioner
    paths = P.shared_paths | P.head_paths

    def step(state: TrainState, batch: Dict[str, Any]):
        rng, (gen,) = _stage_rngs(state, 1)
        params = state.params
        trainable = _leaves(P.extract(params, paths))
        loss, _ = forward(P.merge_into(params, trainable), batch, adapter_mode, gen)
        (grads,) = _grads(loss, trainable)
        lr = lr_at(state.sched_count)
        new_trainable, opt_state = apply_direction(tx, grads, state.opt_states["trainable"],
                                                   _detached(trainable), lr)
        new_state = state.replace(params=P.merge_into(params, new_trainable),
                                  opt_states={"trainable": opt_state},
                                  sched_count=state.sched_count + 1, rng=rng)
        return new_state, {"loss": loss.detach(), "lr": lr}

    return step
