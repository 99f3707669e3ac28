"""SPMD federated engine over a (client, data[, model]) mesh of ranks
(counterpart of ``feddat_tpu/federated/spmd.py``).

The JAX engine runs every client's local DAT training as one jitted
``shard_map`` program over a ``(client, data)`` device mesh.  Here each rank
of a ``torch.distributed`` world (one process per device, as ``torchrun``
starts them; ``parallel/mesh.py``) owns one mesh slot and holds:

  * the frozen backbone (every parameter outside the client partitions);
  * its client's partitions: shared (the communicated subset), local,
    teacher and head;
  * the optimizer state, the schedule count and the client's generator
    (``TrainState``), made afresh each round.

The collectives stand where JAX has its axis reductions:

  * the gradient ``pmean`` over ``data``: the steps of ``train/dat.py`` with
    the rank's data group, an fp32 all-reduce inside the step's captured
    graph; data rank ``d`` of ``D`` assembles only rows
    ``[d·B/D, (d+1)·B/D)`` of its client's batch (JAX's
    ``P(CLIENT_AXIS, DATA_AXIS)``);
  * FedAvg, JAX's weighted sum over the stacked client axis: each rank's
    weighted communicated partition as one flat fp32 buffer, one all-reduce
    over its client group per round; the trained partitions that are neither
    communicated nor personal are reset to their initial values;
  * evaluation: each batch's per-mode score sums, summed over the data
    group and gathered over the clients by one all-reduce over the world, so
    every rank holds the same ``history``;
  * checkpoints: the client states gathered to rank 0, which writes them in
    JAX's layout (``{"stacked_clients": ...}`` as the personal store) through
    ``utils/checkpointing.py``; every rank restores, and the ranks agree on
    the round.

Each rank feeds its own client through the pinned prefetch.  A round runs
the minimum of the clients' ``steps_per_epoch`` steps, or the maximum in
full-epochs mode, where a client that has run out of batches skips its step
(only its own data group, all out of batches too, would have joined its
collective) and each client's step is built on its own schedule horizon
(JAX's per-slot ``_sched_total``).  Per round one seed per client is drawn
from the engine's generator, in client order, as the sequential engine draws
them, so a client's stream does not depend on the world's size, and in a
world of one the engine computes what ``FederatedTrainer`` computes.

With a ``model`` axis (``make_mesh(..., model_parallel=M)``) each slot's
ranks run tensor parallel (``parallel/tp.py``): the backbone is held as this
rank's shards under ``tp_spec_for``, the client partitions replicated over
the model group (in ``PEFTMode.FULL``, whose partition holds the sharded
kernels too, as shards), and every step and evaluation runs under the mesh's
model group.  FedAvg goes over the client group at a fixed (data, model)
index; the evaluation's all-reduce over the world takes the scores of model
index 0 alone, so no score counts once per model rank; checkpoints gather the
shards over the model group first, into JAX's full layout.

All clients share one head module, ``task_<FED_HEAD_KEY>`` (the federated VQA
clients all have 100 labels; classification clients of one head shape, as the
CLI requires); each client trains and keeps its own values.  The model is
ViLT, ViLT-BERT or ALBEF; classification clients come with the CE forward
(``make_forward``) and ``metric="accuracy"``.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from feddat_tpu_torch.configs.core import PEFTMode, TrainConfig
from feddat_tpu_torch.data.pipeline import prefetch_to_device
from feddat_tpu_torch.device import DeviceLike, resolve_device
from feddat_tpu_torch.federated.engine import FederatedTrainer, check_engine_model
from feddat_tpu_torch.models.adapters import MODE_ENSEMBLE
from feddat_tpu_torch.parallel import tp
from feddat_tpu_torch.parallel.mesh import CLIENT_AXIS, DATA_AXIS, RankMesh
from feddat_tpu_torch.peft.partition import (
    ROLE_TEACHER,
    comm_roles,
    label_params,
    param_budget,
    personal_roles,
    teacher_refresh,
)
from feddat_tpu_torch.train.dat import (
    Partitioner,
    init_train_state,
    make_dat_train_step,
    make_plain_train_step,
)
from feddat_tpu_torch.train.evaluation import make_albef_eval_step, make_eval_step
from feddat_tpu_torch.train.forwards import make_albef_forward, make_vilt_forward, to_device
from feddat_tpu_torch.utils.checkpointing import restore_federated_state, save_federated_state
from feddat_tpu_torch.utils.observability import trace
from feddat_tpu_torch.utils.preemption import GracefulPreemption
from feddat_tpu_torch.utils.seeding import check_dropout_rng

logger = logging.getLogger("feddat_tpu_torch")

FED_HEAD_KEY = "fed"  # all SPMD clients share the head module task_<FED_HEAD_KEY>


def client_eval_steps(client) -> int:
    """Number of fixed-size eval batches a client yields: every rank runs
    the largest count, so that all of them reach the collective together."""
    n = int(client.num_eval_examples)
    bs = int(getattr(client, "val_batch_size", None) or client.batch_size)
    return -(-n // bs)


def _all_gather_tree(tree: Dict[str, torch.Tensor], group, size: int) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` of every rank of ``group`` -> ``{name: [size, ...]}``,
    one all-gather per dtype."""
    out: Dict[str, torch.Tensor] = {}
    for dtype in sorted({t.dtype for t in tree.values()}, key=str):
        names = sorted(k for k, t in tree.items() if t.dtype == dtype)
        flat = torch.cat([tree[k].reshape(-1) for k in names])
        parts = [torch.empty_like(flat) for _ in range(size)]
        dist.all_gather(parts, flat, group=group)
        stacked, i = torch.stack(parts), 0
        for k in names:
            n = tree[k].numel()
            out[k] = stacked[:, i:i + n].reshape(size, *tree[k].shape).clone()
            i += n
    return out


class SPMDFederatedTrainer:
    """Runs federated rounds as SPMD over a ``(client, data[, model])`` mesh of ranks."""

    def __init__(self, model, params: Optional[Dict[str, torch.Tensor]], clients: Sequence[Any],
                 config: TrainConfig, mesh: RankMesh, make_forward: Optional[Callable] = None,
                 use_fused: bool = False, checkpoint_dir: Optional[str] = None, metrics_logger=None,
                 family: str = "vilt", answer_banks: Optional[Dict[str, Any]] = None,
                 rank_k: int = 64, metric: str = "vqa_score", pad_token_id: int = 0,
                 full_epochs: bool = False, profile_dir: Optional[str] = None,
                 device: DeviceLike = None):
        """``clients``: one per client slot, in the mesh's client order (every
        rank gets all of them: it feeds its own and reads the others' sizes;
        over more than one data rank, their ``train_batches`` and
        ``eval_batches`` take ``shard=(d, D)``, as the port's clients do).
        ``use_fused`` selects the fused DAT step; ``family`` is ``"vilt"``
        (classification head, VQA score or accuracy) or ``"albef"`` (LM loss,
        rank-answer eval over ``answer_banks[task_key] = (ids, mask)``); every
        PEFT mode runs, DAT on the DAT steps and the rest on the plain step.
        ``full_epochs`` runs each round to the largest client's step count,
        each client on its own schedule horizon (the reference's full-epoch
        loop); by default every client runs the smallest's.  ``metrics_logger``
        must be given on every rank or on none: its step records average the
        clients by a collective."""
        check_engine_model("SPMD engine", model)
        check_dropout_rng(config.dropout_rng)
        self.device = resolve_device(device)
        self.model, self.config, self.mesh, self.family = model, config, mesh, family
        self.checkpoint_dir, self.profile_dir, self.metrics = checkpoint_dir, profile_dir, metrics_logger
        self.clients = list(clients)
        C = mesh.shape[CLIENT_AXIS]
        if len(self.clients) != C:
            raise ValueError(f"{len(self.clients)} clients for client-axis size {C}")
        self.num_clients, self.num_data = C, mesh.shape[DATA_AXIS]
        self.slot, self.data_index = mesh.client_index, mesh.data_index
        self.client = self.clients[self.slot]
        # each data rank assembles only its rows [d·B/D, (d+1)·B/D) of its
        # client's batches (JAX's P(CLIENT_AXIS, DATA_AXIS))
        self._shard = {"shard": (self.data_index, self.num_data)} if self.num_data > 1 else {}
        self.full_epochs = full_epochs
        mode = config.peft_mode

        self.tp = tp.context(mesh)
        if self.tp is not None:
            tp.check_model(model)
        if params is None:
            params = model.state_dict()
        params = {k: v.detach().to(self.device) for k, v in params.items()}
        self.param_budget = b = param_budget(params, mode)
        params = tp.shard_params_tp(params, self.tp)
        self.partitioner = P = Partitioner(params, FED_HEAD_KEY, mode,
                                           layers_to_freeze=config.layers_to_freeze)
        labels = label_params(params)
        self.teacher_paths = frozenset(n for n, l in labels.items() if l == ROLE_TEACHER)
        self.client_paths = P.shared_paths | P.local_paths | P.head_paths | self.teacher_paths
        # FedAvg communicates comm_roles(mode), not the trainable set; a
        # trained partition that is neither communicated nor personal is reset
        # to its initial (the server's) value each round (feddat_tpu/federated/spmd.py:187-206)
        comm, pers = comm_roles(mode), personal_roles(mode)
        self._comm_paths = sorted(p for p in self.client_paths if labels[p] in comm)
        self._round_reset_paths = frozenset(p for p in self.client_paths
                                            if labels[p] not in comm and labels[p] not in pers)
        self._personal_paths = sorted(p for p in self.client_paths if labels[p] in pers)
        self.backbone = {k: v for k, v in params.items() if k not in self.client_paths}
        self._init_client = {k: params[k] for k in self.client_paths}
        self.client_state = dict(self._init_client)

        # the schedule's horizon: the round's step count, or in full-epochs
        # mode this client's own (JAX feeds it per slot as the batch's
        # _sched_total, feddat_tpu/train/dat.py:44-56; a rank runs one slot)
        max_steps = (self.client.steps_per_epoch if full_epochs
                     else min(c.steps_per_epoch for c in self.clients)) * config.num_epochs
        group = mesh.data_group
        if make_forward is None:
            make_forward = ((lambda m, k: make_albef_forward(m, pad_token_id)) if family == "albef"
                            else (lambda m, k: make_vilt_forward(m, k, loss="vqa")))
        forward = make_forward(model, FED_HEAD_KEY)
        if mode != PEFTMode.DAT:
            adapter_mode = "adapter" if mode == PEFTMode.ADAPTER else "none"
            self.train_step = make_plain_train_step(forward, P, config.optimizer, max_steps,
                                                    adapter_mode, data_group=group)
            self._metric_keys = ("loss", "lr")
        elif use_fused:
            self.train_step = FederatedTrainer._build_fused_dat_step(
                model, params, FED_HEAD_KEY, P, config.optimizer, max_steps, data_group=group)
            self._metric_keys = ("loss", "loss_shared", "lr")
        else:
            self.train_step = make_dat_train_step(forward, P, config.optimizer, max_steps,
                                                  data_group=group)
            self._metric_keys = ("loss", "loss_shared", "task_loss", "lr")

        # DAT reports [ensemble, local only, shared only] (task_trainer.py:229-244)
        self._eval_modes = ((MODE_ENSEMBLE, "adapter_0", "adapter_1") if mode == PEFTMode.DAT
                            else ("adapter",) if mode == PEFTMode.ADAPTER else ("none",))
        if family == "albef":
            if answer_banks is None:
                raise ValueError("family='albef' needs answer_banks[task_key]=(ids, mask)")
            ids, mask = answer_banks[self.client.task_key]
            self.eval_step = make_albef_eval_step(model, ids, mask, k=rank_k, pad_token_id=pad_token_id)
        else:
            self.eval_step = make_eval_step(model, FED_HEAD_KEY, metric)

        weights = config.federated.client_weights
        if weights is None:
            weights = [1.0] * C
        elif len(weights) != C:
            raise ValueError(f"client_weights has {len(weights)} entries for a {C}-slot client axis")
        self._weight = float(weights[self.slot]) / float(sum(float(w) for w in weights))

        self.rng = torch.Generator().manual_seed(config.seed)
        self.history: List[Dict[str, Any]] = []
        logger.info("params: total=%d trainable=%d (%.3f%%) communicated=%d personal=%d"
                    " (x%d clients stacked)", b["total"], b["trainable"], b["trainable_pct"],
                    b["communicated"], b["personal"], C)

    # -- views ---------------------------------------------------------------
    @property
    def server_params(self) -> Dict[str, torch.Tensor]:
        """The sequential engine's server parameters: the initial ones with
        the averaged communicated partition."""
        comm = {p: self.client_state[p] for p in self._comm_paths}
        return {**self._init_client, **self.backbone, **comm}

    def personal(self) -> Dict[str, torch.Tensor]:
        """This rank's client's personal partition (the sequential engine's
        ``personal[task_key]``)."""
        return {p: self.client_state[p] for p in self._personal_paths}

    # -- data ----------------------------------------------------------------
    def _train_batches(self, round_idx: int, epoch: int):
        it = self.client.train_batches(epoch=round_idx * 1000 + epoch, **self._shard)
        if self.device.type == "cuda":  # host assembly and copy overlap the previous step
            return prefetch_to_device(it, size=2, device=self.device)
        return it

    # -- rounds --------------------------------------------------------------
    def _log_step(self, metrics: Optional[Dict[str, Any]]) -> None:
        """The metrics logger's step hook; where it writes a record, the
        scalars are first averaged over the clients that stepped (one
        all-reduce over the client group; an exhausted client weighs 0)."""
        if self.metrics is None:
            return
        batch_total = self.num_clients * self.config.batch_size
        if not self.metrics.logs_next():
            self.metrics.step(metrics or {}, batch_total, "spmd")
            return
        vec = torch.zeros(1 + len(self._metric_keys), dtype=torch.float32, device=self.device)
        if metrics is not None:
            vec[0] = 1.0
            for i, k in enumerate(self._metric_keys):
                vec[i + 1] = torch.as_tensor(metrics[k], dtype=torch.float32)
        dist.all_reduce(vec, group=self.mesh.client_group)
        host = vec.cpu()
        count = max(1.0, float(host[0]))
        self.metrics.step({k: float(host[i + 1]) / count for i, k in enumerate(self._metric_keys)},
                          batch_total, "spmd")

    def _fedavg(self) -> None:
        """Weighted sum of the communicated partition over the client group
        (one flat fp32 buffer, one all-reduce), then the round reset."""
        if self._comm_paths:
            flat = torch.cat([(self._weight * self.client_state[p].to(torch.float32)).reshape(-1)
                              for p in self._comm_paths])
            dist.all_reduce(flat, group=self.mesh.client_group)
            i = 0
            for p in self._comm_paths:
                t = self.client_state[p]
                self.client_state[p] = flat[i:i + t.numel()].view(t.shape).to(t.dtype)
                i += t.numel()
        for p in self._round_reset_paths:
            self.client_state[p] = self._init_client[p]

    def run_round(self, round_idx: int) -> None:
        with tp.active(self.tp):
            self._run_round(round_idx)

    def _run_round(self, round_idx: int) -> None:
        t0 = time.time()
        if self.config.peft_mode == PEFTMode.DAT:  # adapter_2 <- adapter_1 (task_trainer.py:36-45)
            self.client_state = teacher_refresh(self.client_state)
        # one seed per client from the engine's generator, in client order
        seeds = [int(torch.randint(0, 2 ** 31 - 1, (1,), generator=self.rng))
                 for _ in range(self.num_clients)]
        state = init_train_state({**self.backbone, **self.client_state}, self.partitioner,
                                 self.config.optimizer, torch.Generator().manual_seed(seeds[self.slot]))
        agg = max if self.full_epochs else min
        round_steps = agg(c.steps_per_epoch for c in self.clients)
        dbg = self.config.debug_steps
        for epoch in range(self.config.federated.local_epochs):
            batches = self._train_batches(round_idx, epoch)
            try:
                for step_idx in range(round_steps):
                    if dbg and step_idx > dbg:
                        break
                    batch, metrics = next(batches, None), None
                    if batch is not None:
                        state, metrics = self.train_step(state, to_device(batch, self.device))
                    self._log_step(metrics)
            finally:
                batches.close()
        self.client_state = {p: state.params[p] for p in self.client_paths}
        self._fedavg()
        self._last_round_wall_s = time.time() - t0
        logger.info("round %d done in %.2fs", round_idx, self._last_round_wall_s)

    def evaluate_round(self, round_idx: int) -> Dict[str, Any]:
        """Per-client scores in the mode's eval modes ([ensemble, adapter_0,
        adapter_1] under DAT), the same ``history`` on every rank.  Every rank
        runs the largest client's eval step count (``--debug`` caps it); a
        client out of batches feeds padding batches with ``valid`` 0."""
        modes = self._eval_modes
        n_steps = max(client_eval_steps(c) for c in self.clients)
        if self.config.debug_steps:
            n_steps = min(n_steps, self.config.debug_steps + 1)
        params = {**self.backbone, **self.client_state}
        parts: List[List[torch.Tensor]] = [[] for _ in modes]
        it, template = self.client.eval_batches(**self._shard), None
        with tp.active(self.tp):
            for _ in range(n_steps):
                batch = next(it, None)
                if batch is None:
                    if template is None:
                        break  # no eval batch at all: this client's sums stay 0
                    batch = {k: np.zeros_like(v) for k, v in template.items()}
                template = template or batch
                batch = to_device(batch, self.device)
                for j, m in enumerate(modes):
                    parts[j].append(self.eval_step(params, batch, adapter_mode=m))
        buf = torch.zeros(self.num_clients, len(modes), n_steps, dtype=torch.float32,
                          device=self.device)
        if parts[0] and self.mesh.model_index == 0:  # a slot's model ranks hold the same scores
            buf[self.slot, :, :len(parts[0])] = torch.stack([torch.stack(p) for p in parts])
        dist.all_reduce(buf)  # the data psum and the gather over clients, at once
        host = buf.cpu().numpy()
        scores = {c.task_key: [float(sum(float(v) for v in host[i, j])) / max(1, c.num_eval_examples)
                               * 100.0 for j in range(len(modes))]
                  for i, c in enumerate(self.clients)}
        entry = {"round": round_idx, "scores": scores}
        self.history.append(entry)
        logger.info("eval %s", entry)
        if self.metrics is not None:
            self.metrics.round(round_idx, scores, getattr(self, "_last_round_wall_s", 0.0))
        return entry

    # -- checkpoint / resume -------------------------------------------------
    def save_checkpoint(self, round_idx: int) -> Optional[str]:
        """Every rank calls it: the data index 0 ranks gather their shards over
        the model group, then the client states over their client group, and
        rank 0 writes the backbone and the stacked client bank."""
        if not self.checkpoint_dir or self.data_index != 0:
            return None
        backbone = tp.gather_params_tp(self.backbone, self.tp)
        state = tp.gather_params_tp(self.client_state, self.tp)
        stacked = _all_gather_tree(state, self.mesh.client_group, self.num_clients)
        if self.mesh.rank != 0:
            return None
        return save_federated_state(self.checkpoint_dir, round_idx, backbone,
                                    {"stacked_clients": stacked}, self.rng)

    def try_resume(self) -> int:
        """Every rank restores the latest round; the ranks must agree on it."""
        if not self.checkpoint_dir:
            return 0
        restored = restore_federated_state(self.checkpoint_dir, device=self.device)
        if dist.get_world_size() > 1:
            mine = torch.tensor([-1 if restored is None else restored[0]], device=self.device)
            rounds = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
            dist.all_gather(rounds, mine)
            rounds = [int(r) for r in rounds]
            if len(set(rounds)) != 1:
                raise ValueError(
                    f"processes disagree on the checkpoint round {rounds}: --checkpoint_dir must be "
                    "one SHARED filesystem path visible to every host (process 0 writes, all read)")
        if restored is None:
            return 0
        rnd, backbone, personal, self.rng = restored
        self.backbone = tp.shard_params_tp(backbone, self.tp)
        self.client_state = tp.shard_params_tp(
            {k: v[self.slot].clone() for k, v in personal["stacked_clients"].items()}, self.tp)
        logger.info("resumed from checkpoint at round %d", rnd)
        return rnd + 1

    def run(self, resume: bool = True) -> List[Dict[str, Any]]:
        """All rounds from the latest checkpoint (``resume``), evaluating every
        ``eval_every`` rounds and after the last.  With a ``checkpoint_dir``
        each round is checkpointed, and at each round boundary every rank asks
        whether any rank got SIGTERM: then all of them stop there, without a
        final evaluation.  With a ``profile_dir`` the first round run here is
        traced."""
        rounds = self.config.federated.comm_rounds
        start = self.try_resume() if resume else 0
        preempted = False
        with GracefulPreemption(enabled=bool(self.checkpoint_dir)) as stop:
            for r in range(start, rounds):
                with trace(self.profile_dir, enabled=bool(self.profile_dir) and r == start):
                    self.run_round(r)
                self.save_checkpoint(r)
                if (r + 1) % self.config.federated.eval_every == 0 or r == rounds - 1:
                    self.evaluate_round(r)
                if self.checkpoint_dir and stop.any_process_requested():
                    logger.warning("preempted: round %d checkpointed; exiting", r)
                    preempted = True
                    break
        if not self.history and rounds > 0 and not preempted:
            # resumed at or after the last round: a run's history is never
            # empty; a preempted run is not a finished one and gets none
            self.evaluate_round(rounds - 1)
        return self.history
