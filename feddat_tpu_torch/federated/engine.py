"""Sequential federated engine (counterpart of ``feddat_tpu/federated/engine.py``,
the reference's communication-round loop ``src/train/main.py:453-558``).

Per round, per client:
  1. client params = server params with the client's personal partition
     swapped in (``main.py:472-478``);
  2. DAT teacher refresh ``adapter_2 <- adapter_1`` (``task_trainer.py:36-45``);
  3. fresh AdamW + schedule (``task_trainer.py:52-63``);
  4. ``local_epochs`` epochs of (DAT or plain) train steps;
  5. re-capture the personal partition; harvest the communicated subset.
Then FedAvg over the harvested subsets into the server params, and every
``eval_every`` rounds an evaluation of each client's personalised model
(``main.py:520-558``).

Parameters are ``{state_dict name: tensor}`` dicts on the engine's device
(CUDA unless ``device="cpu"``).  The model is ViLT (``ViltContinualLearner``),
ViLT-BERT (``ViltBertContinualLearner``) or ALBEF (``AlbefModel``, with the
hooks of ``train/trainers.py``); the ViLT family's classification clients
(NLVR2, SNLI-VE, VCR) take the CE forward, the accuracy metric and their
task's optimizer settings and epoch horizon (``optimizer_overrides``,
``num_epochs_overrides``) from the caller, as the JAX CLI passes them.  Each
client's state carries a ``torch.Generator`` seeded from the engine's, from
which every step draws its per-stage dropout seeds (``train/dat.py``).  The
train and eval steps are compiled (``train/compiled.py``): CUDA graphs on the
card.  Clients whose steps compute the same function (train steps of equal
kind, partitions and optimizer settings, which ALBEF's clients have; eval
steps of equal ``Compiled.key``) share one program, so one capture per step
and shape serves them all; the graphs share one memory pool.  On the card the
train batches come through ``data/pipeline.py::prefetch_to_device`` (pinned,
two batches ahead), as the JAX engine prefetches on an accelerator.

With a ``checkpoint_dir`` every round is checkpointed
(``utils/checkpointing.py``), ``run()`` resumes from the latest round, and a
SIGTERM finishes the round in flight, checkpoints it and returns
(``utils/preemption.py``).  With a ``profile_dir`` the first round that
``run()`` executes is traced with ``torch.profiler`` into that directory
(``utils/observability.py::trace``), as the JAX engine traces it with
``jax.profiler``.  ALBEF's momentum distillation (``aux_init``,
``batch_transform``, ``aux_forward``: the hooks of ``train/trainers.py``)
seeds each client's twin at its start and threads it through the plain
step; the twin is not checkpointed, as in JAX.  ``batch_transform`` runs at
step time, on the batch the prefetch handed over (it returns a new dict).
The engine over a (client, data) mesh of ranks is ``federated/spmd.py``.

Tensor parallelism (``tp_mesh``, a ``(data, model)`` mesh of ranks from
``parallel/tp.py::make_tp_mesh``, one process per rank): each rank holds its
shards of the backbone (``shard_params_tp`` at init and after a resume) and
the replicated trainable partitions, and runs its steps and evaluations
under the mesh's model group (``parallel/tp.py::active``).  Data rank ``d``
of ``D`` takes rows ``[d·B/D, (d+1)·B/D)`` of each batch (``shard=(d, D)``)
and the steps average their gradients over the data group, as the SPMD
engine's do; FedAvg and the personal store work shard by shard; the scores
are summed over the data group only (each model rank holds the same ones).
Checkpoints are gathered over the model group into JAX's full layout and
written by rank 0; every rank restores and reshards.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from feddat_tpu_torch.configs.core import OptimizerConfig, PEFTMode, TrainConfig
from feddat_tpu_torch.data.pipeline import prefetch_to_device
from feddat_tpu_torch.device import DeviceLike, resolve_device
from feddat_tpu_torch.federated.fedavg import fedavg
from feddat_tpu_torch.parallel import tp
from feddat_tpu_torch.parallel.mesh import DATA_AXIS
from feddat_tpu_torch.peft.partition import (
    comm_roles,
    label_params,
    merge,
    param_budget,
    personal_roles,
    split_by_roles,
    teacher_refresh,
)
from feddat_tpu_torch.train.compiled import Compiled
from feddat_tpu_torch.train.dat import (
    Partitioner,
    init_train_state,
    make_dat_train_step,
    make_dat_train_step_fused,
    make_plain_train_step,
)
from feddat_tpu_torch.train.evaluation import evaluate, evaluate_dat, make_eval_step
from feddat_tpu_torch.train.forwards import make_vilt_forward, make_vilt_fused_parts, to_device
from feddat_tpu_torch.train.trainers import check_fused_dropout, make_albef_fused_dat_step
from feddat_tpu_torch.utils.checkpointing import restore_federated_state, save_federated_state
from feddat_tpu_torch.utils.observability import trace
from feddat_tpu_torch.utils.preemption import GracefulPreemption
from feddat_tpu_torch.utils.seeding import check_dropout_rng

logger = logging.getLogger("feddat_tpu_torch")

# the model classes both engines train, as JAX's engines do
ENGINE_MODELS = ("ViltContinualLearner", "ViltBertContinualLearner", "AlbefModel")


def check_engine_model(engine: str, model) -> None:
    """``TypeError`` unless ``model`` is one of the classes the engines train
    (:data:`ENGINE_MODELS`)."""
    if type(model).__name__ not in ENGINE_MODELS:
        raise TypeError(f"the {engine} trains {', '.join(ENGINE_MODELS)}; got "
                        f"{type(model).__name__}")


@dataclasses.dataclass
class ClientRuntime:
    """Per-client step functions and data handle."""

    task_key: str
    data: Any  # train_batches / eval_batches / steps_per_epoch / num_eval_examples
    forward: Callable
    partitioner: Partitioner
    train_step: Callable
    eval_step: Callable
    opt_cfg: OptimizerConfig = None


class FederatedTrainer:
    """Drives communication rounds over a set of clients."""

    def __init__(self, model, params: Optional[Dict[str, torch.Tensor]], clients: Dict[str, Any],
                 config: TrainConfig, make_forward: Optional[Callable] = None,
                 metric: str = "vqa_score", make_eval: Optional[Callable] = None,
                 checkpoint_dir: Optional[str] = None, metrics_logger=None,
                 aux_init: Optional[Callable] = None, batch_transform: Optional[Callable] = None,
                 aux_forward: bool = False, use_fused_dat: bool = False,
                 optimizer_overrides: Optional[Dict[str, OptimizerConfig]] = None,
                 num_epochs_overrides: Optional[Dict[str, int]] = None, tp_mesh=None,
                 profile_dir: Optional[str] = None, device: DeviceLike = None):
        """``params`` defaults to the model's own state_dict; ``make_forward(model,
        task_key)`` and ``make_eval(model, task_key)`` customise the model
        family (ViLT by default).  ``aux_init(params) -> aux`` seeds each
        client's auxiliary state at its start (ALBEF's momentum twin),
        ``aux_forward`` marks the forward as aux-threading (the plain step's),
        ``batch_transform(batch, epoch, step, steps_per_epoch)`` rewrites
        each batch (the distillation alpha ramp).  ``tp_mesh``: the ``(data,
        model)`` mesh of ranks this process is one of (``params`` whole on
        every rank; the engine keeps this rank's shards)."""
        check_engine_model("federated engine", model)
        check_dropout_rng(config.dropout_rng)
        self.device = resolve_device(device)
        self.model = model
        self.config = config
        self.mode = config.peft_mode
        if params is None:
            params = model.state_dict()
        params = {k: v.detach().to(self.device) for k, v in params.items()}
        self.param_budget = param_budget(params, self.mode)
        self.tp_mesh, self.tp, self._shard, data_group = tp_mesh, None, {}, None
        self._data_ranks = 1 if tp_mesh is None else tp_mesh.size(DATA_AXIS)
        if tp_mesh is not None:
            self.tp, data_group = tp.context(tp_mesh), tp_mesh.data_group
            if self.tp is not None:
                tp.check_model(model)
            if self._data_ranks > 1:  # this rank's rows of every batch
                self._shard = {"shard": (tp_mesh.data_index, self._data_ranks)}
            params = tp.shard_params_tp(params, self.tp)
        self.server_params = params
        self.labels = label_params(params)
        self._personal_roles = personal_roles(self.mode)
        self._comm_roles = comm_roles(self.mode)
        self.rng = torch.Generator().manual_seed(config.seed)
        make_forward = make_forward or (lambda m, k: make_vilt_forward(m, k, loss="vqa"))

        self.clients: List[ClientRuntime] = []
        # programs shared by clients.  A train step's body is fixed by its
        # kind, its partitions and its optimizer settings: the model and the
        # frozen weights are the engine's, and a client's forward differs from
        # another's only in its task head, whose paths are in head_paths (ViLT's
        # task_<key> heads; ALBEF's one cls head, so ALBEF clients share)
        self._programs: Dict[Any, Any] = {}
        for task_key, data in clients.items():
            forward = make_forward(model, task_key)
            part = Partitioner(params, task_key, self.mode, layers_to_freeze=config.layers_to_freeze)
            n_epochs = (num_epochs_overrides or {}).get(task_key, config.num_epochs)
            max_steps = data.steps_per_epoch * n_epochs
            opt_cfg = (optimizer_overrides or {}).get(task_key, config.optimizer)
            if self.mode == PEFTMode.DAT:
                if use_fused_dat:
                    step = self._build_fused_dat_step(model, params, task_key, part, opt_cfg,
                                                      max_steps, data_group)
                else:
                    step = make_dat_train_step(forward, part, opt_cfg, max_steps, data_group)
            else:
                adapter_mode = "adapter" if self.mode == PEFTMode.ADAPTER else "none"
                step = make_plain_train_step(forward, part, opt_cfg, max_steps, adapter_mode,
                                             aux_forward=aux_forward, data_group=data_group)
            step.share(self._programs, (step.program.name, part.shared_paths, part.local_paths,
                                        part.head_paths, opt_cfg))
            eval_step = make_eval(model, task_key) if make_eval else make_eval_step(model, task_key, metric)
            if isinstance(eval_step, Compiled) and eval_step.key is not None:
                eval_step.share(self._programs, eval_step.key)
            self.clients.append(ClientRuntime(task_key, data, forward, part, step, eval_step, opt_cfg))

        # every client starts from the same personal partition (main.py:440-450)
        init_personal, _ = split_by_roles(params, self.labels, self._personal_roles)
        self.personal: Dict[str, Dict[str, torch.Tensor]] = {
            c.task_key: dict(init_personal) for c in self.clients}
        self.history: List[Dict[str, Any]] = []
        self.checkpoint_dir = checkpoint_dir
        self.profile_dir = profile_dir
        self.metrics = metrics_logger
        self.aux_init = aux_init
        self.batch_transform = batch_transform
        b = self.param_budget
        logger.info("params: total=%d trainable=%d (%.3f%%) communicated=%d personal=%d",
                    b["total"], b["trainable"], b["trainable_pct"], b["communicated"], b["personal"])

    @staticmethod
    def _build_fused_dat_step(model, params, task_key, part, opt_cfg, max_steps, data_group=None):
        """The fused DAT step (one ensemble encoder pass, ``engine.py:206-262``):
        ALBEF's through ``make_albef_fused_dat_step`` with the client's
        partitioner; ViLT's encoder and head, stochastic where the model has
        live dropout (``check_fused_dropout`` logs the one deviation).  The
        SPMD engine builds its step here too, with its ``data_group``."""
        if type(model).__name__ == "AlbefModel":
            return make_albef_fused_dat_step(model, params, opt_cfg, max_steps, part=part,
                                             data_group=data_group)[0]
        live = check_fused_dropout(model, carries=True)
        return make_dat_train_step_fused(*make_vilt_fused_parts(model, task_key, live > 0.0), part,
                                         opt_cfg, max_steps, data_group=data_group)

    def _client_params(self, client: ClientRuntime, refresh: bool = True) -> Dict[str, torch.Tensor]:
        """Server params with the client's personal partition swapped in;
        ``refresh`` applies the DAT teacher refresh (train start only — eval
        uses the stored personal ``adapter_2``, engine.py:273-290)."""
        _, rest = split_by_roles(self.server_params, self.labels, self._personal_roles)
        params = merge(rest, self.personal[client.task_key])
        if refresh and self.mode == PEFTMode.DAT:
            params = teacher_refresh(params)
        return params

    def train_client(self, client: ClientRuntime, round_idx: int) -> Dict[str, torch.Tensor]:
        """One client's local training; returns its full post-training params."""
        with tp.active(self.tp):
            return self._train_client(client, round_idx)

    def _train_client(self, client: ClientRuntime, round_idx: int) -> Dict[str, torch.Tensor]:
        params = self._client_params(client)
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=self.rng))
        state = init_train_state(params, client.partitioner, client.opt_cfg,
                                 torch.Generator().manual_seed(seed))
        if self.aux_init is not None:
            state = state.replace(aux=self.aux_init(params))
        spe = client.data.steps_per_epoch
        for epoch in range(self.config.federated.local_epochs):
            it = client.data.train_batches(epoch=round_idx * 1000 + epoch, **self._shard)
            if self.device.type == "cuda":
                # the host's batch assembly and copy overlap the previous step
                it = prefetch_to_device(it, size=2, device=self.device)
            for step_idx, batch in enumerate(it):
                if self.config.debug_steps and step_idx > self.config.debug_steps:
                    break
                if self.batch_transform is not None:
                    batch = self.batch_transform(batch, epoch, step_idx, spe)
                state, metrics = client.train_step(state, to_device(batch, self.device))
                if self.metrics is not None:  # the scalars; the DAT steps' gradient sets stay here
                    scalars = {k: v for k, v in metrics.items() if k != "grads"}
                    rows = next(iter(batch.values())).shape[0] * self._data_ranks
                    self.metrics.step(scalars, rows, client.task_key)
        return state.params

    def _absorb(self, client: ClientRuntime, trained: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        self.personal[client.task_key], _ = split_by_roles(trained, self.labels, self._personal_roles)
        return split_by_roles(trained, self.labels, self._comm_roles)[0]

    def run_round(self, round_idx: int) -> None:
        t0 = time.time()
        comm = [self._absorb(c, self.train_client(c, round_idx)) for c in self.clients]
        if comm and self._comm_roles:
            _, rest = split_by_roles(self.server_params, self.labels, self._comm_roles)
            self.server_params = merge(rest, fedavg(comm, self.config.federated.client_weights))
        self._last_round_wall_s = time.time() - t0
        logger.info("round %d done in %.2fs", round_idx, self._last_round_wall_s)

    def _evaluate_client(self, client: ClientRuntime):
        params = self._client_params(client, refresh=False)
        n, dbg = client.data.num_eval_examples, self.config.debug_steps
        batches = lambda: client.data.eval_batches(**self._shard)  # noqa: E731
        with tp.active(self.tp):
            if self.mode == PEFTMode.DAT:
                scores = evaluate_dat(params, client.eval_step, batches, n, debug_steps=dbg)
            else:
                mode = "adapter" if self.mode == PEFTMode.ADAPTER else "none"
                scores = evaluate(params, client.eval_step, batches(), n, mode, debug_steps=dbg)
        if not self._shard:
            return scores
        # each data rank scored its rows: the sum over the data group (not
        # the world, where every score would count once per model rank)
        t = torch.tensor(scores, dtype=torch.float64, device=self.device)
        dist.all_reduce(t, group=self.tp_mesh.data_group)
        return t.tolist()

    def evaluate_round(self, round_idx: int) -> Dict[str, Any]:
        """Evaluate each client's personalised model (``main.py:520-558``)."""
        entry = {"round": round_idx,
                 "scores": {c.task_key: self._evaluate_client(c) for c in self.clients}}
        self.history.append(entry)
        logger.info("eval %s", entry)
        if self.metrics is not None:
            self.metrics.round(round_idx, entry["scores"], getattr(self, "_last_round_wall_s", 0.0))
        return entry

    def run_single_task(self) -> Dict[str, Any]:
        """Centralised baseline (``--do_single``, ``main.py:402-436``): each
        task trains ``comm_rounds`` times on its own from the initial params,
        then evaluates; the trainer is left as it started."""
        init_server = self.server_params
        init_personal, _ = split_by_roles(init_server, self.labels, self._personal_roles)
        results = {}
        for client in self.clients:
            self.server_params = init_server
            self.personal[client.task_key] = dict(init_personal)
            for r in range(self.config.federated.comm_rounds):
                comm = self._absorb(client, self.train_client(client, r))
                if self._comm_roles:
                    _, rest = split_by_roles(self.server_params, self.labels, self._comm_roles)
                    self.server_params = merge(rest, comm)
            results[client.task_key] = self._evaluate_client(client)
        self.server_params = init_server
        for c in self.clients:
            self.personal[c.task_key] = dict(init_personal)
        entry = {"round": -1, "scores": results, "single_task": True}
        self.history.append(entry)
        return entry

    def save_checkpoint(self, round_idx: int) -> Optional[str]:
        """Under ``tp_mesh`` every rank calls it: the shards are gathered over
        the model group into JAX's full layout and rank 0 writes them."""
        if not self.checkpoint_dir:
            return None
        server, personal = self.server_params, self.personal
        if self.tp_mesh is not None:
            server = tp.gather_params_tp(server, self.tp)
            personal = {k: tp.gather_params_tp(v, self.tp) for k, v in personal.items()}
            if self.tp_mesh.rank != 0:
                return None
        return save_federated_state(self.checkpoint_dir, round_idx, server, personal, self.rng)

    def try_resume(self) -> int:
        """Restore the latest checkpoint; returns the next round index."""
        if not self.checkpoint_dir:
            return 0
        restored = restore_federated_state(self.checkpoint_dir, device=self.device)
        if restored is None:
            return 0
        rnd, server, personal, self.rng = restored
        # the checkpoint holds whole tensors: reshard them, or the rest of the
        # run would hold a replicated backbone (JAX's engine.py:390-395)
        self.server_params = tp.shard_params_tp(server, self.tp)
        self.personal = {k: tp.shard_params_tp(v, self.tp) for k, v in personal.items()}
        logger.info("resumed from checkpoint at round %d", rnd)
        return rnd + 1

    def run(self, resume: bool = True) -> List[Dict[str, Any]]:
        """All ``comm_rounds`` rounds from the latest checkpoint (``resume``),
        with evaluation every ``eval_every`` rounds and after the last.  With a
        ``checkpoint_dir`` each round is checkpointed, and a SIGTERM finishes
        the round in flight, checkpoints it and returns without a final
        evaluation; the relaunch resumes.  With a ``profile_dir`` the first
        round run here is traced."""
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
                if stop.requested:
                    logger.warning("preempted: round %d checkpointed; exiting", r)
                    preempted = True
                    break
        if not self.history and rounds > 0 and not preempted:
            # resumed at or after the last round: a run's history is never
            # empty; a preempted run is not a finished one and gets none
            self.evaluate_round(rounds - 1)
        return self.history
