"""The ranks of the tensor-parallel CPU tests (``tests/test_torch_tp.py``).

:func:`start` starts a world of ``n`` processes joined over gloo from a file
store under the test's ``tmp_path`` (no port, so parallel test workers never
collide) and returns while they run; each rank runs the given cases in
order, each on a mesh of its own over the same world, and writes what it
holds to ``rank<r>.pt``.  Nothing
here imports JAX: the references run in the test process."""

from __future__ import annotations

from pathlib import Path
from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from feddat_tpu_torch.configs.core import OptimizerConfig, PEFTMode
from feddat_tpu_torch.data.synthetic import SyntheticAlbefClient, SyntheticVQAClient
from feddat_tpu_torch.federated.engine import FederatedTrainer
from feddat_tpu_torch.federated.spmd import SPMDFederatedTrainer
from feddat_tpu_torch.parallel import tp
from feddat_tpu_torch.parallel.mesh import make_mesh
from feddat_tpu_torch.train.dat import (
    Partitioner,
    init_train_state,
    make_dat_train_step,
    make_plain_train_step,
)
from feddat_tpu_torch.train.forwards import make_albef_forward, make_vilt_forward, to_device
from feddat_tpu_torch.utils.checkpointing import latest_round

Case = Tuple[str, str, Dict[str, Any]]
CPU = torch.device("cpu")


def make_model(family: str, model_cfg, heads, weights: str = None, seed: int = 0):
    """The port's model with the weights saved at ``weights`` (or its own
    init from ``seed``)."""
    if family == "albef":
        from feddat_tpu_torch.models.albef import AlbefModel, init_albef_params

        model, init = AlbefModel(model_cfg), init_albef_params
    else:
        from feddat_tpu_torch.models.vilt import ViltContinualLearner, init_vilt_params

        model, init = ViltContinualLearner(model_cfg, heads), init_vilt_params
    if weights is None:
        return init(model, seed).eval()
    model.load_state_dict(torch.load(weights, weights_only=True), strict=True)
    return model.eval()


def _host(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in tree.items()}


def shards(model_cfg, heads, weights, family="vilt") -> Dict[str, Any]:
    """Shard a whole state dict over a (data, model) mesh and gather it back."""
    mesh = tp.make_tp_mesh(2, device_type="cpu")
    ctx = tp.context(mesh)
    full = make_model(family, model_cfg, heads, weights).state_dict()
    local = tp.shard_params_tp(full, ctx)
    back = tp.gather_params_tp(local, ctx)
    return {"bitwise": all(torch.equal(back[k], v) for k, v in full.items()),
            "shapes": {k: (tuple(v.shape), tuple(full[k].shape)) for k, v in local.items()},
            "bytes": tp.backbone_bytes(local), "full_bytes": tp.backbone_bytes(full)}


def forward(family, model_cfg, heads, weights, batch, task_key=None) -> Dict[str, Any]:
    """``tp_forward`` at (data=2, model=2) on this rank's rows of ``batch``."""
    mesh = tp.make_tp_mesh(2, 2, device_type="cpu")
    model = make_model(family, model_cfg, heads, weights)
    fn, place_batch = tp.tp_forward(model, mesh, task_key)
    out = fn(tp.shard_params_tp(model.state_dict(), tp.context(mesh)), place_batch(batch))
    return {"data": mesh.data_index, "out": out.clone()}


def seq_round(model_cfg, heads, weights, clients, config, ckpt) -> Dict[str, Any]:
    """One round of the sequential engine on a (data=2, model=2) mesh, with a
    checkpoint; then a fresh tp=2 engine resumes from it."""
    mesh = tp.make_tp_mesh(2, 2, device_type="cpu")
    ctx = tp.context(mesh)
    data = {c["task_key"]: SyntheticVQAClient(**c) for c in clients}
    model = make_model("vilt", model_cfg, heads, weights)
    trainer = FederatedTrainer(model, None, data, config, tp_mesh=mesh, checkpoint_dir=ckpt,
                               device="cpu")
    history = trainer.run(resume=False)
    dist.barrier()
    again = FederatedTrainer(model, None, data, config, tp_mesh=mesh, checkpoint_dir=ckpt,
                             device="cpu")
    start = again.try_resume()
    return {"server": _host(tp.gather_params_tp(trainer.server_params, ctx)),
            "local": _host(trainer.server_params), "history": history,
            "latest": latest_round(ckpt), "resumed_at": start,
            "resumed_bitwise": all(torch.equal(again.server_params[k], v)
                                   for k, v in trainer.server_params.items()),
            "personal_bitwise": all(torch.equal(again.personal[c][k], v)
                                    for c, p in trainer.personal.items() for k, v in p.items())}


def albef_step(model_cfg, weights, client, opt) -> Dict[str, Any]:
    """One standard DAT step of ALBEF at (data=2, model=2): this data rank's
    rows of the batch, the gradients averaged over the data group."""
    mesh = tp.make_tp_mesh(2, 2, device_type="cpu")
    model = make_model("albef", model_cfg, None, weights)
    batch = next(SyntheticAlbefClient(**client).train_batches(0, shard=(mesh.data_index, 2)))
    params = tp.shard_params_tp(model.state_dict(), tp.context(mesh))
    part = Partitioner(params, "c", PEFTMode.DAT)
    step = make_dat_train_step(make_albef_forward(model), part, opt, 10,
                               data_group=mesh.data_group)
    with tp.active(tp.context(mesh)):
        _, metrics = step(init_train_state(params, part, opt, torch.Generator().manual_seed(3)),
                          to_device(batch, CPU))
    return {"loss": float(metrics["loss"])}


def spmd_round(model_cfg, heads, weights, clients, config) -> Dict[str, Any]:
    """One round of the SPMD engine on a (client=2, data=1, model=2) mesh and
    its evaluation."""
    mesh = make_mesh(2, 1, model_parallel=2, device_type="cpu")
    data = [SyntheticVQAClient(**c) for c in clients]
    trainer = SPMDFederatedTrainer(make_model("vilt", model_cfg, heads, weights), None, data,
                                   config, mesh, device="cpu")
    trainer.run_round(0)
    scores = trainer.evaluate_round(0)
    return {"slot": mesh.client_index, "scores": scores,
            "state": _host(tp.gather_params_tp(trainer.client_state, tp.context(mesh)))}


def _grads(forward, params, trainable, batch, mode, seed):
    leaves = {k: params[k].detach().requires_grad_() for k in trainable}
    loss, _ = forward({**params, **leaves}, batch, mode, torch.Generator().manual_seed(seed))
    return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def modes(model_cfg, heads, batch, mode: str, lr: float) -> Dict[str, Any]:
    """One step of ``mode`` at model=2 (each model group on the whole batch,
    the data groups apart) beside the same step at tp=1 in this process:
    the trainable partition's gradients and the updated parameters, both
    gathered whole."""
    mesh = tp.make_tp_mesh(2, device_type="cpu")
    ctx = tp.context(mesh)
    model = make_model("vilt", model_cfg, heads, seed=0)
    forward = make_vilt_forward(model, "t")
    full = {k: v.detach() for k, v in model.state_dict().items()}
    local = tp.shard_params_tp(full, ctx)
    batch = to_device(batch, CPU)
    opt = OptimizerConfig(lr=lr, warmup_ratio=0.0)
    out = {}
    for name, params, c in (("tp1", full, None), ("tp2", local, ctx)):
        part = Partitioner(params, "t", PEFTMode(mode))
        if mode == "dat":
            step = make_dat_train_step(forward, part, opt, 10)
        else:
            step = make_plain_train_step(forward, part, opt, 10)
        trainable = sorted(part.shared_paths | part.local_paths | part.head_paths)
        with tp.active(c):
            state, metrics = step(init_train_state(params, part, opt,
                                                   torch.Generator().manual_seed(7)), batch)
            grads = ({f"{s}:{k}": v for s, g in metrics["grads"].items() for k, v in g.items()}
                     if mode == "dat" else _grads(forward, params, trainable, batch, "none", 5))
        if c is not None:
            out["replicated"] = _host({k: state.params[k] for k in trainable
                                       if tp.tp_spec_for(k, state.params[k]) is None})
        out[name] = {"grads": _host(tp.gather_params_tp(grads, c)),
                     "params": _host(tp.gather_params_tp({k: state.params[k] for k in trainable}, c)),
                     "loss": float(metrics["loss"]), "trainable": trainable}
    return out


def cli(argv: List[str], task: Dict[str, Any]) -> Dict[str, Any]:
    """``feddat_tpu_torch.cli.main(argv)`` on this world (as ``torchrun``
    would start it), the task registered in this process first."""
    import json

    from feddat_tpu_torch import cli as tcli
    from feddat_tpu_torch.configs.tasks import TaskSpec, register_task

    register_task(TaskSpec(**task), overwrite=True)
    assert tcli.main(argv) == 0
    logs = argv[argv.index("--output_dir") + 1]
    found = sorted(Path(logs).glob("*.history.json")) if dist.get_rank() == 0 else []
    return {"history": json.loads(found[0].read_text()) if found else None}


CASES: Dict[str, Callable[..., Dict[str, Any]]] = {
    "shards": shards, "forward": forward, "seq_round": seq_round, "albef_step": albef_step,
    "spmd_round": spmd_round, "modes": modes, "cli": cli}


def _rank(rank: int, world: int, store: str, cases: List[Case], out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world)
    try:
        results = {name: CASES[fn](**kw) for name, fn, kw in cases}
        torch.save(results, Path(out) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


class World:
    """A world of ranks started by :func:`start`; :attr:`results` waits for
    it to end (the caller works meanwhile) -> each rank's results."""

    def __init__(self, context, out: Path, world: int):
        self._context, self._out, self._world, self._results = context, out, world, None

    def close(self) -> None:
        """End any rank still running (a caller that never waited for it)."""
        for process in self._context.processes:
            if process.is_alive():
                process.terminate()
            process.join()

    @property
    def results(self) -> List[Dict[str, Any]]:
        if self._results is None:
            while not self._context.join():
                pass
            self._results = [torch.load(self._out / f"rank{r}.pt", weights_only=False)
                             for r in range(self._world)]
        return self._results


def start(world: int, tmp_path: Path, cases: List[Case]) -> World:
    """Start ``cases`` on a world of ``world`` ranks and return at once."""
    out = Path(tmp_path) / f"world{world}"
    out.mkdir(parents=True, exist_ok=True)
    context = mp.start_processes(_rank, args=(world, str(out / "store"), cases, str(out)),
                                 nprocs=world, join=False, start_method="spawn")
    return World(context, out, world)
