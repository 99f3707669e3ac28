"""Train steps: DAT + Mutual-KD (standard, fused and joint), and the single-update step.

Counterpart of ``feddat_tpu/train/dat.py``.  The reference's DAT step
(``task_trainer.py:280-330``) is three forwards and two backward/AdamW steps
per batch:

  ① ensemble {adapter_0, adapter_2} forward, no grad -> logits_all
  ② adapter_1 forward; L1 = (task + KL(l1 ‖ logits_all))/2; update adapter_1 + head
  ③ ensemble forward; L0 = (task + KL(l0 ‖ l1))/2; update adapter_0 + head

Each step is ``step(state, batch) -> (state, metrics)``: the trainable
partitions are detached copies that require grad, passed into the model
with ``torch.func.functional_call``; the two updates share one schedule
clock (lr(c) then lr(c+1), c advances by 2) and the head's Adam state
advances in both, exactly as in JAX.  Each ``make_*`` factory stands for
the JAX ``*_step_core`` and the ``make_*`` that jits it: it returns a
:class:`~feddat_tpu_torch.train.compiled.Compiled` step (:func:`compile_step`),
a host prologue, a device body replayed as a CUDA graph on the card, and a
host epilogue.  The metrics hold the losses, the lr and ``grads``: both
updates' gradient sets (adapter and head partitions only).

Dropout: as JAX splits ``state.rng`` into per-stage keys, each step's
prologue draws per-stage seeds from a copy of ``state.rng``
(``utils/seeding.py::split_rng``; the copy, advanced by the same draw every
step, is the new state's ``rng``), and the body draws its masks from one
dropout generator per stage on the parameters' device, seeded with them: the
standard step d0 (①), d1 (②), d2 (③); the fused step d0 (the ensemble pass
that ① and ③ share) and d1 (the adapter_1 pass); the joint step one (its
mega-batch pass is deterministic); the plain step one, two with ALBEF's
momentum distillation (the twin's forward, then the model's).  The same
state gives the same masks; ``torch.manual_seed`` changes nothing.
``TrainConfig.dropout_rng`` selects nothing here: "threefry" and "rbg" (the
TPU's hardware bit generator in JAX) give the same torch generators
(``utils/seeding.py::check_dropout_rng``).

Data parallelism: every ``make_*`` takes an optional ``data_group``, the
``torch.distributed`` group of the ranks that train one client on their own
rows of its batch (the SPMD engine's data axis, ``federated/spmd.py``).  With
a group, each gradient set is averaged over it in fp32 (:func:`mean_over`)
where JAX's cores apply ``pmean`` over the data axis: after the gradients,
before AdamW; the scalar metrics are averaged too.  The all-reduce runs
inside the device body, so a replayed graph holds it.  Without a group the
body is the one above.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, FrozenSet, Sequence, Tuple

import torch

from feddat_tpu_torch.configs.core import OptimizerConfig, PEFTMode
from feddat_tpu_torch.models.adapters import MODE_ENSEMBLE, MODE_WEIGHTED
from feddat_tpu_torch.peft.partition import (
    ROLE_HEAD,
    ROLE_LOCAL,
    ROLE_SHARED,
    label_params,
    trainable_roles,
)
from feddat_tpu_torch.train.losses import kd_kl_loss
from feddat_tpu_torch.train.compiled import Compiled
from feddat_tpu_torch.train.optim import (
    AdamState,
    AdamWDirection,
    adamw_direction,
    polynomial_schedule,
)
from feddat_tpu_torch.train.state import TrainState
from feddat_tpu_torch.utils.seeding import split_rng

Params = Dict[str, torch.Tensor]


# the layer stacks and the global index of their first layer: ALBEF's text
# encoder is one BERT split into text_layers and fusion_layers, so fusion
# stacks (the decoder's too) count from the text depth (dat.py:116-131)
_STACKS = ("layers", "blocks", "text_layers", "fusion_layers")
# ViT embedding tensors that live outside any *embeddings* module
_VISION_EMBEDS = ("patch_embed", "pos_embed", "cls_token")


def mean_over(group, *subs: Dict[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], ...]:
    """Each tensor of ``subs`` averaged over the ranks of ``group`` in fp32
    (JAX's ``pmean``): one flat buffer, one all-reduce (it runs in a group of
    one too), the sum divided by the group's size and cast back to each
    tensor's dtype."""
    import torch.distributed as dist

    flat = torch.cat([t.reshape(-1).to(torch.float32) for s in subs for t in s.values()])
    dist.all_reduce(flat, group=group)
    flat = flat / dist.get_world_size(group)
    out, i = [], 0
    for sub in subs:
        out.append({})
        for k, t in sub.items():
            out[-1][k] = flat[i:i + t.numel()].view(t.shape).to(t.dtype)
            i += t.numel()
    return tuple(out)


def _frozen_bottom(names, layers_to_freeze: int) -> Callable[[str], bool]:
    """Under ``freeze_bottom_k_layers`` (dat.py:106-152): ``name -> frozen``,
    the embeddings and the layers of global index ``< k``."""
    text_depth = 1 + max((int(p[p.index("text_layers") + 1]) for p in (n.split(".") for n in names)
                          if "text_layers" in p), default=-1)
    offset = {"layers": 0, "blocks": 0, "text_layers": 0, "fusion_layers": text_depth}

    def frozen(name: str) -> bool:
        parts = name.split(".")
        if any("embeddings" in part for part in parts) or any(p in _VISION_EMBEDS for p in parts):
            return True
        stack = next((p for p in parts if p in _STACKS), None)
        return stack is not None and offset[stack] + int(parts[parts.index(stack) + 1]) < layers_to_freeze

    return frozen


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
            frozen = (_frozen_bottom(labels, layers_to_freeze) if mode == PEFTMode.FREEZE_BOTTOM_K
                      else lambda name: False)
            self.shared_paths = frozenset(
                n for n, l in labels.items()
                if l in roles and "text_bert" not in n.split(".") and not frozen(n))
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


def _update(tx: AdamWDirection, grads: Params, moments: Dict[str, Params], params: Params, lr,
            bias_correction) -> Tuple[Params, Dict[str, Params]]:
    """One AdamW update in a device body: ``moments = {"mu", "nu"}``; ``lr``
    and the bias corrections are 0-dim device tensors."""
    updates, mu, nu = tx.moments(grads, moments["mu"], moments["nu"], params, bias_correction)
    return {k: params[k] + updates[k] * lr for k in params}, {"mu": mu, "nu": nu}


def _scalars(sc: torch.Tensor, updates: Dict[str, int]):
    """The body's view of the prologue's scalars -> (lrs, {partition: [(bc1,
    bc2) per update]}), in :func:`compile_step`'s order."""
    n_lr = max(updates.values())
    lrs, i, bcs = [sc[j] for j in range(n_lr)], n_lr, {}
    for part, n in updates.items():
        bcs[part] = [(sc[i + 2 * j], sc[i + 2 * j + 1]) for j in range(n)]
        i += 2 * n
    return lrs, bcs


def compile_step(body: Callable, tx: AdamWDirection, lr_at: Callable[[int], float],
                 n_stages: int, updates: Dict[str, int], name: str,
                 aux: bool = False, data_group=None) -> Compiled:
    """``step(state, batch) -> (new state, metrics)`` around a device body
    (``train/compiled.py``).  ``updates`` maps each optimizer partition to the
    number of its updates per step; the schedule advances by the largest.

    The prologue does the host part of the step as before, in float32: it
    splits ``state.rng`` into the next rng and ``n_stages`` dropout seeds
    (the same state gives the same masks), computes the lr of each schedule
    tick and each update's bias corrections, and packs them into one fp32
    tensor.  The body gets ``{"params", "opt": {partition: {"mu", "nu"}},
    "batch", "scalars"}`` (and ``"aux"``, the state's auxiliary tensors,
    with ``aux``) and the stage generators, and returns ``{"params", "opt",
    <metrics>}`` (and ``"aux"``); the epilogue builds the new state (counts,
    schedule, rng, aux) and adds the last lr to the metrics.  The aux tensors
    are resident (``train/compiled.py``): the new state holds the program's
    own tensors, which the next step updates in place without a copy; a twin
    passed in for the first time is copied, never written.  With a
    ``data_group`` the body's scalar metrics are averaged over it."""
    n_lr = max(updates.values())
    if data_group is not None:
        inner = body

        def body(inp, gens):
            out = inner(inp, gens)
            keys = [k for k, v in out.items() if k not in ("params", "opt", "aux", "grads")
                    and isinstance(v, torch.Tensor) and v.dim() == 0]
            (means,) = mean_over(data_group, {k: out[k] for k in keys})
            return {**out, **means}

    def prologue(state: TrainState, batch: Dict[str, Any]):
        rng, seeds = split_rng(state.rng, n_stages)
        lrs = [lr_at(state.sched_count + j) for j in range(n_lr)]
        vals = list(lrs)
        for part, n in updates.items():
            for j in range(n):
                vals.extend(tx.bias_correction(state.opt_states[part].count + j + 1))
        inputs = {"params": state.params,
                  "opt": {p: {"mu": state.opt_states[p].mu, "nu": state.opt_states[p].nu}
                          for p in updates},
                  "batch": batch, "scalars": torch.tensor(vals, dtype=torch.float32)}
        if aux:
            inputs["aux"] = state.aux
        return inputs, seeds, (state, rng, lrs[-1])

    def epilogue(host, out):
        state, rng, lr = host
        opt = {p: AdamState(state.opt_states[p].count + n, out["opt"][p]["mu"], out["opt"][p]["nu"])
               for p, n in updates.items()}
        new_state = state.replace(params=out["params"], opt_states=opt,
                                  sched_count=state.sched_count + n_lr, rng=rng,
                                  aux=out["aux"] if aux else state.aux)
        metrics = {k: v for k, v in out.items() if k not in ("params", "opt", "aux")}
        metrics["lr"] = lr
        return new_state, metrics

    return Compiled(body, prologue, epilogue, name, resident=("aux",) if aux else ())


_DAT_UPDATES = {"shared": 1, "local": 1, "head": 2}


def make_dat_train_step(forward, partitioner: Partitioner, opt_cfg: OptimizerConfig,
                        max_steps: int, data_group=None) -> Compiled:
    """The standard DAT step (``dat_step_core``): ``forward(params, batch,
    adapter_mode, gen) -> (task_loss, logits)``, three forwards, two updates."""
    tx = adamw_direction(opt_cfg)
    P = partitioner

    def body(inp, gens):
        d0, d1, d2 = gens
        params, opt, batch = inp["params"], inp["opt"], inp["batch"]
        (lr1, lr0), bcs = _scalars(inp["scalars"], _DAT_UPDATES)
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
        if data_group is not None:
            g_shared, g_head2 = mean_over(data_group, g_shared, g_head2)
        new_shared, m_shared = _update(tx, g_shared, opt["shared"], _detached(shared), lr1,
                                       bcs["shared"][0])
        head, m_head = _update(tx, g_head2, opt["head"], _detached(head), lr1, bcs["head"][0])
        params = P.merge_into(P.merge_into(params, new_shared), head)
        logits_1 = logits_1.detach()

        # ③ local-adapter update through the ensemble forward
        local = _leaves(P.extract(params, P.local_paths))
        head = _leaves(head)
        task_l0, logits_0 = forward(P.merge_into(P.merge_into(params, local), head), batch,
                                    MODE_ENSEMBLE, d2)
        l0 = (task_l0 + kd_kl_loss(logits_0, logits_1)) / 2.0
        g_local, g_head = _grads(l0, local, head)
        if data_group is not None:
            g_local, g_head = mean_over(data_group, g_local, g_head)
        new_local, m_local = _update(tx, g_local, opt["local"], _detached(local), lr0,
                                     bcs["local"][0])
        head, m_head = _update(tx, g_head, m_head, _detached(head), lr0, bcs["head"][1])
        params = P.merge_into(P.merge_into(params, new_local), head)
        grads = {"shared": g_shared, "head_2": g_head2, "local": g_local, "head_3": g_head}
        return {"params": params, "opt": {"shared": m_shared, "local": m_local, "head": m_head},
                "loss": l0.detach(), "loss_shared": l1.detach(), "task_loss": task_l0.detach(),
                "grads": grads}

    return compile_step(body, tx, polynomial_schedule(opt_cfg, max_steps), 3, _DAT_UPDATES,
                        "dat_step", data_group=data_group)


def make_dat_train_step_fused(encode_fn, head_fn, task_loss_fn, partitioner: Partitioner,
                              opt_cfg: OptimizerConfig, max_steps: int,
                              data_group=None) -> Compiled:
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
    P = partitioner

    def body(inp, gens):
        d0, d1 = gens
        params, opt, batch = inp["params"], inp["opt"], inp["batch"]
        (lr1, lr0), bcs = _scalars(inp["scalars"], _DAT_UPDATES)
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
        if data_group is not None:
            g_shared, g_head2 = mean_over(data_group, g_shared, g_head2)
        new_shared, m_shared = _update(tx, g_shared, opt["shared"], shared, lr1, bcs["shared"][0])
        head, m_head = _update(tx, g_head2, opt["head"], head, lr1, bcs["head"][0])
        params = P.merge_into(P.merge_into(params, new_shared), head)
        logits_1 = logits.detach()

        # ③ local update: the new head on the saved pooled, back through the saved graph
        head_l = _leaves(head)
        logits = head_fn(head_l, pooled)
        l0 = (task_loss_fn(logits, batch) + kd_kl_loss(logits, logits_1)) / 2.0
        g_head, g_local = _grads(l0, head_l, local)
        if data_group is not None:
            g_local, g_head = mean_over(data_group, g_local, g_head)
        new_local, m_local = _update(tx, g_local, opt["local"], _detached(local), lr0,
                                     bcs["local"][0])
        head, m_head = _update(tx, g_head, m_head, head, lr0, bcs["head"][1])
        params = P.merge_into(P.merge_into(params, new_local), head)
        grads = {"shared": g_shared, "head_2": g_head2, "local": g_local, "head_3": g_head}
        return {"params": params, "opt": {"shared": m_shared, "local": m_local, "head": m_head},
                "loss": l0.detach(), "loss_shared": l1.detach(), "grads": grads}

    return compile_step(body, tx, polynomial_schedule(opt_cfg, max_steps), 2, _DAT_UPDATES,
                        "dat_step_fused", data_group=data_group)


def make_dat_train_step_joint(encode_fn, head_fn, task_loss_fn, partitioner: Partitioner,
                              opt_cfg: OptimizerConfig, max_steps: int,
                              adapter_names: Sequence[str] = ("adapter_0", "adapter_1", "adapter_2"),
                              ensemble_weight: float = 0.5,
                              adapter_scaling: float = 1.0, data_group=None) -> Compiled:
    """DAT step as ONE mega-batched encoder pass and ONE backward
    (``dat_step_core_joint``, dat.py:418-591).  The ensemble pass and the
    adapter_1 pass use disjoint adapters, so they run as one pass over 2B
    rows in ``MODE_WEIGHTED``: rows 0..B-1 carry the ensemble weights
    (``ensemble_weight`` on adapter_0, the rest on adapter_2), rows B..2B-1
    adapter_1 alone.  A zero weight gives that row no gradient to that
    adapter, so one backward of the pass returns adapter_1's gradient (from
    the second half) and adapter_0's (from the first).  The head is sequenced
    as in the standard step: ② at the initial head and lr(c), ③ at the head
    ② updated and lr(c+1).  Exact against :func:`make_dat_train_step` when
    the encoder has no live dropout: the pass is deterministic (``encode_fn``
    gets the one stage generator, which a deterministic encoder ignores;
    ``trainers.check_fused_dropout(model, carries=False)`` warns when the
    model's dropout is dropped).  ``batch_size`` is ``batch["input_ids"]``'s
    first dimension.

    ``adapter_names``, ``ensemble_weight`` and ``adapter_scaling`` must be the
    model's ``AdapterSpec``'s.  ``adapter_scaling`` must be 1.0: the weighted
    rows are scaled, the standard step's adapter_1 pass is not."""
    if adapter_scaling != 1.0:
        raise ValueError(
            f"the joint DAT step requires AdapterSpec.scaling == 1.0 (got "
            f"{adapter_scaling}): its stage-② rows run through MODE_WEIGHTED "
            "(which scales, reference adapter.py:144,161) while the standard "
            "step's adapter_1 pass does not (adapter.py:124-130) — any other "
            "value breaks joint==standard equivalence.  Use the standard or "
            "fused step.")
    tx = adamw_direction(opt_cfg)
    P = partitioner
    w_row = {name: i for i, name in enumerate(adapter_names)}
    ens = ((w_row["adapter_0"], ensemble_weight), (w_row["adapter_2"], 1.0 - ensemble_weight))
    single = ((w_row["adapter_1"], 1.0),)

    def weights(rows, b, device):
        w = torch.zeros(len(adapter_names), device=device)
        for i, v in rows:  # fills on the device: nothing to copy from the host in a capture
            w[i:i + 1].fill_(v)
        return w.expand(b, -1)

    def body(inp, gens):
        (d0,) = gens
        params, opt, batch = inp["params"], inp["opt"], inp["batch"]
        (lr1, lr0), bcs = _scalars(inp["scalars"], _DAT_UPDATES)
        head = P.extract(params, P.head_paths)
        local = _leaves(P.extract(params, P.local_paths))
        shared = _leaves(P.extract(params, P.shared_paths))
        b = batch["input_ids"].shape[0]
        device = batch["input_ids"].device
        batch2 = {k: torch.cat([v, v]) for k, v in batch.items()}
        batch2["adapter_weights"] = torch.cat([weights(ens, b, device), weights(single, b, device)])
        pooled2 = encode_fn(P.merge_into(P.merge_into(params, local), shared), batch2,
                            MODE_WEIGHTED, d0)
        pooled_ens, pooled_1 = pooled2[:b].detach(), pooled2[b:].detach()
        with torch.no_grad():
            logits_all = head_fn(head, pooled_ens)

        # ② the head-level loss at the initial head
        head_l, pooled_1 = _leaves(head), pooled_1.requires_grad_()
        logits = head_fn(head_l, pooled_1)
        l1 = (task_loss_fn(logits, batch) + kd_kl_loss(logits, logits_all)) / 2.0
        g_head2, g_pooled_1 = _grads(l1, head_l, {"pooled": pooled_1})
        if data_group is not None:
            (g_head2,) = mean_over(data_group, g_head2)
        head, m_head = _update(tx, g_head2, opt["head"], head, lr1, bcs["head"][0])
        logits_1 = logits.detach()

        # ③ the head-level loss at the updated head
        head_l, pooled_ens = _leaves(head), pooled_ens.requires_grad_()
        logits = head_fn(head_l, pooled_ens)
        l0 = (task_loss_fn(logits, batch) + kd_kl_loss(logits, logits_1)) / 2.0
        g_head, g_pooled_ens = _grads(l0, head_l, {"pooled": pooled_ens})

        # one backward of the mega-batch pass for both stages
        cot = torch.cat([g_pooled_ens["pooled"], g_pooled_1["pooled"]])
        flat = torch.autograd.grad(pooled2, [*local.values(), *shared.values()], cot)
        g_local = dict(zip(local, flat[:len(local)]))
        g_shared = dict(zip(shared, flat[len(local):]))
        if data_group is not None:
            g_local, g_shared, g_head = mean_over(data_group, g_local, g_shared, g_head)
        new_shared, m_shared = _update(tx, g_shared, opt["shared"], _detached(shared), lr1,
                                       bcs["shared"][0])
        new_local, m_local = _update(tx, g_local, opt["local"], _detached(local), lr0,
                                     bcs["local"][0])
        head, m_head = _update(tx, g_head, m_head, head, lr0, bcs["head"][1])
        params = P.merge_into(P.merge_into(P.merge_into(params, new_shared), new_local), head)
        grads = {"shared": g_shared, "head_2": g_head2, "local": g_local, "head_3": g_head}
        return {"params": params, "opt": {"shared": m_shared, "local": m_local, "head": m_head},
                "loss": l0.detach(), "loss_shared": l1.detach(), "grads": grads}

    return compile_step(body, tx, polynomial_schedule(opt_cfg, max_steps), 1, _DAT_UPDATES,
                        "dat_step_joint", data_group=data_group)


def make_plain_train_step(forward, partitioner: Partitioner, opt_cfg: OptimizerConfig,
                          max_steps: int, adapter_mode: str = "none",
                          aux_forward: bool = False, data_group=None) -> Compiled:
    """One forward/backward/update for the non-DAT modes (``plain_step_core``,
    ``task_trainer.py:433-450``).  The gradient covers the trainable
    partition only.

    With ``aux_forward`` (ALBEF's momentum distillation) the forward is
    ``forward(params, batch, mode, (g1, g2), aux) -> (loss, logits, aux)``:
    it gets two stage generators (JAX splits the step's key in two inside
    its distill forward, ``forwards.py:85``) and the state's ``aux``, which
    it updates in place without a gradient; the step threads it through
    ``state.aux`` (resident in the compiled program, :func:`compile_step`)."""
    tx = adamw_direction(opt_cfg)
    P = partitioner
    paths = P.shared_paths | P.head_paths
    updates = {"trainable": 1}

    def body(inp, gens):
        params = inp["params"]
        (lr,), bcs = _scalars(inp["scalars"], updates)
        trainable = _leaves(P.extract(params, paths))
        full = P.merge_into(params, trainable)
        out = {}
        if aux_forward:
            loss, _, out["aux"] = forward(full, inp["batch"], adapter_mode, gens, inp["aux"])
        else:
            loss, _ = forward(full, inp["batch"], adapter_mode, gens[0])
        (grads,) = _grads(loss, trainable)
        if data_group is not None:
            (grads,) = mean_over(data_group, grads)
        new_trainable, moments = _update(tx, grads, inp["opt"]["trainable"], _detached(trainable),
                                         lr, bcs["trainable"][0])
        return {"params": P.merge_into(params, new_trainable), "opt": {"trainable": moments},
                "loss": loss.detach(), **out}

    return compile_step(body, tx, polynomial_schedule(opt_cfg, max_steps), 2 if aux_forward else 1,
                        updates, "plain_step_distill" if aux_forward else "plain_step",
                        aux=aux_forward, data_group=data_group)
