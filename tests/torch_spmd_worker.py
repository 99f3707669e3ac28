"""The ranks of the SPMD engine's CPU tests (``tests/test_torch_spmd.py``).

:func:`spawn` starts a world of ``n`` processes joined over gloo from a file
store under the test's ``tmp_path`` (no port, so parallel test workers never
collide); each rank runs the given cases in order, each on a mesh of its own
over the same world, and writes what it holds to ``rank<r>.pt``.  Nothing
here imports JAX: the references run in the test process."""

from __future__ import annotations

import os
import signal
from pathlib import Path
from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from feddat_tpu_torch.data.synthetic import SyntheticAlbefClient, SyntheticVQAClient
from feddat_tpu_torch.federated.spmd import SPMDFederatedTrainer
from feddat_tpu_torch.parallel.mesh import make_mesh
from feddat_tpu_torch.utils.checkpointing import latest_round

Case = Tuple[str, Dict[str, Any]]


def make_model(family: str, model_cfg, heads, weights: str, attn_impl: str = "auto"):
    """The port's model with the weights saved at ``weights``."""
    if family == "albef":
        from feddat_tpu_torch.models.albef import AlbefModel

        model = AlbefModel(model_cfg, attn_impl=attn_impl)
    else:
        from feddat_tpu_torch.models.vilt import ViltContinualLearner

        model = ViltContinualLearner(model_cfg, heads, attn_impl=attn_impl)
    model.load_state_dict(torch.load(weights, weights_only=True), strict=True)
    return model.eval()


def snli_ve_client(root: str, vocab: str, batch_size: int, seed: int, key: str, canvas, text_len):
    """A SNLI-VE client from the files under ``root``, as the CLI builds it."""
    from feddat_tpu_torch.data.classification_datasets import SnliVePipeline, load_snli_ve_examples
    from feddat_tpu_torch.data.images import make_backend
    from feddat_tpu_torch.data.tokenizer import WordPieceTokenizer

    data_dir = os.path.join(root, "snli-ve")
    pipe = SnliVePipeline(load_snli_ve_examples(data_dir, "train"),
                          make_backend("flickr30k", "snli-ve", root),
                          WordPieceTokenizer.from_vocab_file(vocab), text_len, canvas, batch_size,
                          seed=seed, eval_examples=load_snli_ve_examples(data_dir, "dev"))
    pipe.task_key = key
    return pipe


def make_clients(family: str, specs: Sequence[Dict[str, Any]]):
    if family == "snli-ve":
        return [snli_ve_client(**spec) for spec in specs]
    cls = SyntheticAlbefClient if family == "albef" else SyntheticVQAClient
    return [cls(**spec) for spec in specs]


def _sigterm_in_round(client, round_idx: int) -> None:
    """Deliver SIGTERM to this process when ``client``'s batches of round
    ``round_idx`` are first asked for (epoch ids are round * 1000 + epoch)."""
    inner = client.train_batches

    def batches(epoch=0):
        if epoch // 1000 == round_idx:
            os.kill(os.getpid(), signal.SIGTERM)
        yield from inner(epoch)

    client.train_batches = batches


def run_engine(family: str, model_cfg, heads, weights: str, clients: Sequence[Dict[str, Any]],
               config, mesh_shape: Tuple[int, int], attn_impl: str = "auto", resume: bool = False,
               sigterm: Tuple[int, int] = None, **engine_kw) -> Dict[str, Any]:
    """One ``SPMDFederatedTrainer.run`` on a ``mesh_shape`` mesh -> this rank's
    slot, client state, server view, history and latest checkpoint round.
    ``sigterm = (rank, round)`` signals that rank in that round.  Family
    ``"snli-ve"``: ViLT on SNLI-VE clients read from disk, with the CE
    forward (``metric="accuracy"`` comes in ``engine_kw``)."""
    mesh = make_mesh(*mesh_shape, device_type="cpu")
    model = make_model(family, model_cfg, heads, weights, attn_impl)
    if family == "snli-ve":
        from feddat_tpu_torch.train.forwards import make_vilt_forward

        engine_kw["make_forward"] = lambda m, k: make_vilt_forward(m, k, loss="ce")
    data = make_clients(family, clients)
    if sigterm is not None and dist.get_rank() == sigterm[0]:
        _sigterm_in_round(data[mesh.client_index], sigterm[1])
    if family == "albef":
        engine_kw["answer_banks"] = {c.task_key: (c.answer_ids, c.answer_mask) for c in data}
    trainer = SPMDFederatedTrainer(model, None, data, config, mesh,
                                   family="albef" if family == "albef" else "vilt", device="cpu",
                                   **engine_kw)
    history = trainer.run(resume=resume)
    ckpt = engine_kw.get("checkpoint_dir")
    return {"slot": mesh.client_index, "data": mesh.data_index, "history": history,
            "latest": latest_round(ckpt) if ckpt else None,
            "client_state": {k: v.clone() for k, v in trainer.client_state.items()},
            "server": {k: v.clone() for k, v in trainer.server_params.items()}}


def _rank(rank: int, world: int, store: str, cases: List[Case], out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world)
    try:
        results = {name: run_engine(**kw) for name, kw in cases}
        torch.save(results, Path(out) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(world: int, tmp_path: Path, cases: List[Case]) -> List[Dict[str, Any]]:
    """Run ``cases`` on a world of ``world`` ranks -> each rank's results."""
    out = Path(tmp_path) / f"world{world}"
    out.mkdir(parents=True, exist_ok=True)
    mp.start_processes(_rank, args=(world, str(out / "store"), cases, str(out)), nprocs=world,
                       start_method="spawn")
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]
