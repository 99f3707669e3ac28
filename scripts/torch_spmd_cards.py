"""The SPMD engine's collectives across cards: one round and its evaluation of
ViLT-B/32 DAT (bf16, the fused step on ``"layer"``, B=64 per client) on a
(client, data) mesh of ranks, one process per card, with CUDA graphs and
eagerly.

    torchrun --standalone --nproc_per_node 4 scripts/torch_spmd_cards.py [--clients 2]
    torchrun --standalone --nproc_per_node 4 scripts/torch_spmd_cards.py --device cpu --small

``--small`` runs a 2-layer, 32-wide ViLT in fp32 on the composable route, as
the CLI's ``--smoke``; ``--device cpu`` joins the ranks over gloo, where the
port runs no graphs.  Each rank feeds its own rows of its client's batches.
Checks (exit 1 on a failure):

* the data ranks of a client end the round with bitwise equal client
  partitions (the step's gradient mean keeps them in step); every rank holds
  the same communicated partition and the same history;
* the round with graphs is bitwise the eager round: every all-reduce here sums
  the terms of two ranks (and zeros), which no summation order changes;
* on the card: the round captures its step with the step's all-reduce called
  inside the capture, and one profiled replay launches its NCCL kernels from
  the graph and calls no all-reduce from the host
  (``chip_smoke.graph_collectives``).

Rank 0 prints the card's name and power limit, each round's seconds (the
graph round's include its captures) and the replayed step's device ms with
its NCCL kernels' share.
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke  # noqa: E402
from chip_smoke import CollectiveCalls, check, graph_collectives  # noqa: E402
from feddat_tpu_torch.configs.core import (  # noqa: E402
    FederatedConfig,
    OptimizerConfig,
    PEFTMode,
    TrainConfig,
    ViltModelConfig,
    adapter_spec_for_mode,
)
from feddat_tpu_torch.data.synthetic import SyntheticVQAClient  # noqa: E402
from feddat_tpu_torch.federated.spmd import FED_HEAD_KEY, SPMDFederatedTrainer  # noqa: E402
from feddat_tpu_torch.models.vilt import TaskHeadSpec  # noqa: E402
from feddat_tpu_torch.parallel.mesh import DATA_AXIS, local_device, make_mesh, world  # noqa: E402
from feddat_tpu_torch.train import compiled  # noqa: E402
from feddat_tpu_torch.train.dat import init_train_state  # noqa: E402
from feddat_tpu_torch.train.forwards import to_device  # noqa: E402

STEPS = 2


def build_model(small: bool, device: torch.device, seed: int):
    """-> (model, its config, its weights, the client's batch shapes)."""
    if small:
        from feddat_tpu_torch.models.vilt import ViltContinualLearner, init_vilt_params

        heads = {FED_HEAD_KEY: TaskHeadSpec(num_labels=16)}
        cfg = ViltModelConfig(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                              max_text_len=16, image_size=(64, 64), patch_size=32,
                              adapter=adapter_spec_for_mode(PEFTMode.DAT, 4))
        with torch.device("meta"):
            model = ViltContinualLearner(cfg, heads)
        model = init_vilt_params(model.to_empty(device=device), seed)
        shapes = dict(num_labels=16, vocab_size=cfg.vocab_size, text_len=cfg.max_text_len,
                      image_size=cfg.image_size, batch=8)
    else:
        from feddat_tpu_torch.models import create_model

        heads = {FED_HEAD_KEY: TaskHeadSpec(num_labels=chip_smoke.NUM_LABELS)}
        model, cfg = create_model("vilt", heads, PEFTMode.DAT, 16, "bfloat16",
                                  image_size=chip_smoke.TCANVAS, attn_impl="layer", device=device,
                                  seed=seed)
        shapes = dict(num_labels=chip_smoke.NUM_LABELS, vocab_size=30522,
                      text_len=chip_smoke.TEXT_LEN, image_size=chip_smoke.TCANVAS,
                      batch=chip_smoke.TB)
    return model, {k: v.detach() for k, v in model.state_dict().items()}, shapes


def one_round(model, params, clients, config, mesh, device):
    """-> (trainer, its history entry, the round's seconds, its all-reduce calls)."""
    trainer = SPMDFederatedTrainer(model, params, clients, config, mesh, use_fused=True,
                                   device=device)
    dist.barrier()
    t0 = time.perf_counter()
    with CollectiveCalls() as calls:
        trainer.run_round(0)
        entry = trainer.evaluate_round(0)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return trainer, entry, time.perf_counter() - t0, calls


def gathered(tree, group, size):
    """Every rank of ``group``'s tensors, flattened in name order."""
    flat = torch.cat([tree[k].reshape(-1).to(torch.float32) for k in sorted(tree)])
    parts = [torch.empty_like(flat) for _ in range(size)]
    dist.all_gather(parts, flat, group=group)
    return parts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--clients", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = local_device(args.device)
    with world(device) as size:
        rank = dist.get_rank()
        if device.type == "cuda":
            if rank == 0:
                smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                      "--format=csv,noheader"], capture_output=True, text=True,
                                     timeout=60, check=True)
                print(smi.stdout.strip().splitlines()[0])
                from feddat_tpu_torch.ops import _build

                _build.build()  # once, before the other ranks load the libraries
            dist.barrier()
        mesh = make_mesh(args.clients, device_type=device.type)
        D = mesh.shape[DATA_AXIS]
        model, params, shapes = build_model(args.small, device, args.seed)
        B = shapes.pop("batch")
        clients = [SyntheticVQAClient(f"client_{i}", num_train=STEPS * B, num_eval=B, batch_size=B,
                                      val_batch_size=B, seed=args.seed + 1 + i, **shapes)
                   for i in range(args.clients)]
        config = TrainConfig(peft_mode=PEFTMode.DAT, optimizer=OptimizerConfig(),
                             federated=FederatedConfig(comm_rounds=1, local_epochs=1, eval_every=1),
                             num_epochs=1, seed=args.seed)
        if rank == 0:
            print(f"spmd cards: a world of {size} over {dist.get_backend()}, mesh {args.clients} "
                  f"clients x {D} data ranks, B={B} per client ({B // D} rows per rank), "
                  f"{STEPS} steps", flush=True)
        runs = {}
        for graphs in (True, False):
            mode = contextlib.nullcontext() if graphs else compiled.disable_graphs()
            with mode:
                cap0, rep0 = compiled.STATS["captures"], compiled.STATS["replays"]
                trainer, entry, secs, calls = one_round(model, params, clients, config, mesh, device)
                captures = compiled.STATS["captures"] - cap0
                replays = compiled.STATS["replays"] - rep0
                runs[graphs] = dict(state={k: v.clone() for k, v in trainer.client_state.items()},
                                    entry=entry, comm=list(trainer._comm_paths))
                if rank == 0:
                    print(f"spmd cards: {'graphs' if graphs else 'eager'}: round and evaluation "
                          f"{secs:.3f} s; {captures} captures, {replays} replays, {calls.calls} "
                          f"all-reduce calls ({calls.captured} inside a capture); {entry['scores']}",
                          flush=True)
                if graphs and device.type == "cuda":
                    check(captures >= 1 and replays >= 1 and calls.captured >= 1,
                          f"rank {rank}: {captures} captures, {replays} replays, "
                          f"{calls.captured} all-reduce calls inside a capture")
                    state = init_train_state({**trainer.backbone, **trainer.client_state},
                                             trainer.partitioner, config.optimizer,
                                             torch.Generator().manual_seed(1))
                    batch = next(trainer.client.train_batches(0, shard=(mesh.data_index, D)))
                    batch = to_device(batch, device)
                    busy, nccl = graph_collectives(torch, f"rank {rank}",
                                                   lambda: trainer.train_step(state, batch),
                                                   nccl_kernels=D > 1)
                    if rank == 0:
                        print(f"spmd cards: the replayed step: device busy {busy:.3f} ms, NCCL "
                              f"kernels {nccl:.3f} ms ({100 * nccl / busy:.2f}%)", flush=True)
                    del state, batch
                del trainer
        graph, eager = runs[True], runs[False]
        bad = [k for k, v in graph["state"].items() if not torch.equal(v, eager["state"][k])]
        check(not bad, f"rank {rank}: the graph round differs from the eager round: {bad[:4]}")
        check(graph["entry"] == eager["entry"], f"rank {rank}: the histories differ")
        # the data ranks of a client hold one client state; all ranks one
        # communicated partition and one history
        parts = gathered(graph["state"], mesh.data_group, D)
        check(all(torch.equal(p, parts[0]) for p in parts),
              f"rank {rank}: the data ranks of client {mesh.client_index} differ")
        comm = {k: graph["state"][k] for k in graph["comm"]}
        parts = gathered(comm, None, size)
        check(all(torch.equal(p, parts[0]) for p in parts), "the communicated partitions differ")
        entries = [None] * size
        dist.all_gather_object(entries, graph["entry"])
        check(all(e == entries[0] for e in entries), "the ranks' histories differ")
        if rank == 0:
            print(f"spmd cards: {len(graph['state'])} client tensors bitwise equal across each "
                  f"client's {D} data ranks and between the graph and eager rounds; "
                  f"{len(comm)} communicated tensors equal on all {size} ranks")
    return 0


if __name__ == "__main__":
    sys.exit(main())
