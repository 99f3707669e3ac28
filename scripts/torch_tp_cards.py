"""Tensor parallelism across cards: full-width ViLT-B/32 and ALBEF DAT (bf16,
``attn_impl="auto"``, the fused step) with the frozen backbone sharded over a
``model`` axis of ranks (``feddat_tpu_torch/parallel/tp.py``), one process
per card, with CUDA graphs and eagerly.

    torchrun --standalone --nproc_per_node 4 scripts/torch_tp_cards.py [--family vilt,albef]
    torchrun --standalone --nproc_per_node 4 scripts/torch_tp_cards.py --device cpu --small

``--small`` runs 2-layer, 32-wide models in fp32, as the CLI's ``--smoke``;
``--device cpu`` joins the ranks over gloo, where the port runs no graphs.
For each family, one round of 2 steps and its evaluation on:

* the sequential engine at (data=W/2, model=2) and the SPMD engine at
  (client=2, data=W/4, model=2), each with graphs and eagerly: the replayed
  round is bitwise the eager one (every sum has the terms of two ranks), the
  model ranks of a slot end with bitwise equal replicated partitions, the
  step's model-group all-reduces are counted on the host in an eager step
  against 2 forward plus up to 2 backward reductions per layer (3 and 4 in
  a cross-attending layer), and on the card one profiled replay launches
  that many NCCL kernels from its graph and calls no all-reduce from the
  host (``chip_smoke.graph_collectives``);
* the sequential engine at tp = 1, 2 and 4 (data = W/tp): each rank's bytes
  of the sharded kernels and of all parameters, and on the card the replayed
  step's device ms and its NCCL kernels' share.  Each tp's update of the
  communicated partition and its scores are held against tp = 1 in fp32 by
  the 2x-bf16 rule (``chip_smoke.py`` phase 18): tp = M's error is at most
  twice tp = 1's in bf16, or 1e-2, and each score within twice tp = 1's
  distance or one example's score.  ALBEF runs these with its BERT dropout
  off: each data rank draws the masks of its own rows from its slot's
  generator, so splits over 4, 2 and 1 data ranks would draw different
  masks (the first two bullets keep dropout live).

The heads are small enough to score above zero after two steps: 16 labels
for ViLT, an 8-answer bank for ALBEF (a random 3129-label head, or a
70-answer bank, scores 0 and leaves the scores' checks nothing to compare).

Rank 0 prints the card's name and power limit and every number.  Exit 1 on a
failed check.
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
from chip_smoke import (  # noqa: E402
    TRAIN_GRAD_FACTOR,
    TRAIN_GRAD_FLOOR,
    CollectiveCalls,
    check,
    graph_collectives,
    set_error,
)
from feddat_tpu_torch.configs.core import (  # noqa: E402
    AlbefBertConfig,
    AlbefModelConfig,
    FederatedConfig,
    OptimizerConfig,
    PEFTMode,
    TrainConfig,
    ViltModelConfig,
    adapter_spec_for_mode,
)
from feddat_tpu_torch.data.synthetic import SyntheticAlbefClient, SyntheticVQAClient  # noqa: E402
from feddat_tpu_torch.federated.engine import FederatedTrainer  # noqa: E402
from feddat_tpu_torch.federated.spmd import FED_HEAD_KEY, SPMDFederatedTrainer  # noqa: E402
from feddat_tpu_torch.models.vilt import TaskHeadSpec  # noqa: E402
from feddat_tpu_torch.parallel import tp  # noqa: E402
from feddat_tpu_torch.parallel.mesh import DATA_AXIS, local_device, make_mesh, world  # noqa: E402
from feddat_tpu_torch.train import compiled  # noqa: E402
from feddat_tpu_torch.train.dat import init_train_state  # noqa: E402
from feddat_tpu_torch.train.forwards import to_device  # noqa: E402
from feddat_tpu_torch.train.trainers import resolve_trainer  # noqa: E402

STEPS = 2
ALBEF_BATCH = 16  # questions per client batch (x 4 answers)
ALBEF_ANSWERS = 8  # the answer bank
LABELS = chip_smoke.TP_LABELS


def build(family: str, small: bool, device: torch.device, seed: int, dtype: str = "bfloat16",
          dropout: bool = True):
    """-> (model, client factory, sequential and SPMD engine keywords, layer
    counts, batch) of one family; ``--small`` is fp32 whatever ``dtype``,
    ``dropout`` False turns ALBEF's BERT rates to 0."""
    if family == "vilt":
        # the SPMD engine's shared head and the sequential engine's one per client
        heads = {k: TaskHeadSpec(num_labels=LABELS) for k in (FED_HEAD_KEY, "client_0", "client_1")}
        if small:
            from feddat_tpu_torch.models.vilt import ViltContinualLearner, init_vilt_params

            cfg = ViltModelConfig(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                                  max_text_len=16, image_size=(64, 64), patch_size=32,
                                  adapter=adapter_spec_for_mode(PEFTMode.DAT, 4))
            with torch.device("meta"):
                model = ViltContinualLearner(cfg, heads)
            model = init_vilt_params(model.to_empty(device=device), seed)
            shapes = dict(num_labels=LABELS, vocab_size=cfg.vocab_size, text_len=cfg.max_text_len,
                          image_size=cfg.image_size, batch=8)
        else:
            from feddat_tpu_torch.models import create_model

            model, cfg = create_model("vilt", heads, PEFTMode.DAT, 16, dtype,
                                      image_size=chip_smoke.TCANVAS, attn_impl="auto",
                                      device=device, seed=seed)
            shapes = dict(num_labels=LABELS, vocab_size=30522,
                          text_len=chip_smoke.TEXT_LEN, image_size=chip_smoke.TCANVAS,
                          batch=chip_smoke.TB)
        b = shapes.pop("batch")

        def client(i):
            return SyntheticVQAClient(f"client_{i}", num_train=STEPS * b, num_eval=b, batch_size=b,
                                      val_batch_size=b, seed=seed + 1 + i, **shapes)

        layers = {"self": cfg.num_layers, "cross": 0}
        return model, client, {}, {}, layers, b
    from feddat_tpu_torch.models.albef import AlbefModel, init_albef_params

    if small:
        rate = 0.1 if dropout else 0.0
        cfg = AlbefModelConfig(image_res=32, patch_size=16, vision_width=32, vision_layers=2,
                               vision_heads=4,
                               bert=AlbefBertConfig(vocab_size=96, hidden_size=32, num_layers=4,
                                                    num_heads=4, intermediate_size=64,
                                                    max_position_embeddings=16, fusion_layer=2,
                                                    encoder_width=32, hidden_dropout=rate,
                                                    attention_dropout=rate),
                               decoder_layers=2, max_question_len=8, max_answer_len=4,
                               adapter=adapter_spec_for_mode(PEFTMode.DAT, 4))
        with torch.device("meta"):
            model = AlbefModel(cfg)
        model = init_albef_params(model.to_empty(device=device), seed)
        shapes = dict(vocab_size=96, question_len=8, answer_len=4, image_size=(32, 32), batch=4,
                      answers=ALBEF_ANSWERS)
    else:
        model = chip_smoke.albef_train_model(torch, seed, "auto", dtype=dtype, dropout=dropout)
        cfg = model.cfg
        shapes = dict(vocab_size=30522, question_len=chip_smoke.LQ, answer_len=chip_smoke.LA,
                      image_size=(chip_smoke.ARES, chip_smoke.ARES), batch=ALBEF_BATCH,
                      answers=ALBEF_ANSWERS)
    b, n_answers = shapes.pop("batch"), shapes.pop("answers")

    def client(i):
        return SyntheticAlbefClient(f"client_{i}", num_train=STEPS * b, num_eval=b,
                                    num_answers=n_answers, max_answers_per_q=4, batch_size=b,
                                    val_batch_size=b, seed=seed + 1 + i, **shapes)

    banks = {f"client_{i}": (client(i).answer_ids, client(i).answer_mask) for i in range(2)}
    hooks = resolve_trainer("albef_no_distill", "vqa", rank_k=8, answer_banks=banks)
    seq_kw = dict(make_forward=hooks.make_forward, make_eval=hooks.make_eval)
    spmd_kw = dict(family="albef", answer_banks=banks, rank_k=8)
    bert = cfg.bert
    layers = {"self": cfg.vision_layers + bert.fusion_layer,
              "cross": bert.num_layers - bert.fusion_layer + cfg.decoder_layers}
    return model, client, seq_kw, spmd_kw, layers, b


def engine(kind, model, client, config, mesh, device, kw):
    if kind == "spmd":
        return SPMDFederatedTrainer(model, None, [client(i) for i in range(2)], config, mesh,
                                    use_fused=True, device=device, **kw)
    clients = {f"client_{i}": client(i) for i in range(2)}
    return FederatedTrainer(model, None, clients, config, use_fused_dat=True, tp_mesh=mesh,
                            device=device, **kw)


def state_of(trainer, kind):
    """This rank's trained partitions (server and personal store)."""
    if kind == "spmd":
        return {k: v.clone() for k, v in trainer.client_state.items()}
    out = {f"server/{k}": v.clone() for k, v in trainer.server_params.items() if "adapter" in k
           or "task_" in k}
    for c, p in trainer.personal.items():
        out.update({f"{c}/{k}": v.clone() for k, v in p.items()})
    return out


def one_step(trainer, kind, mesh, device):
    """A fresh state and a batch of this rank's rows -> ``call()`` of one train
    step (the first client's, on the sequential engine)."""
    if kind == "spmd":
        runtime_step, part, client = trainer.train_step, trainer.partitioner, trainer.client
        params = {**trainer.backbone, **trainer.client_state}
        opt = trainer.config.optimizer
    else:
        rt = trainer.clients[0]
        runtime_step, part, client, opt = rt.train_step, rt.partitioner, rt.data, rt.opt_cfg
        params = trainer._client_params(rt)
    d, n = mesh.data_index, mesh.size(DATA_AXIS)
    batch = to_device(next(client.train_batches(0, **({"shard": (d, n)} if n > 1 else {}))), device)
    state = init_train_state(params, part, opt, torch.Generator().manual_seed(1))
    return lambda: runtime_step(state, batch)


def run_mesh(family, kind, shape, built, config, device, graphs_and_eager=True, tag=""):
    """One round and its evaluation on one mesh (graphs, then eagerly) ->
    the numbers rank 0 prints, and the graph round's update of the
    communicated partition (``adapter_1``) and its history entry."""
    model, client, seq_kw, spmd_kw, layers, b = built
    rank, world_size = dist.get_rank(), dist.get_world_size()
    if kind == "spmd":
        mesh = make_mesh(2, shape[0], model_parallel=shape[1], device_type=device.type)
    else:
        mesh = tp.make_tp_mesh(shape[1], shape[0], device_type=device.type)
    ctx = tp.context(mesh)
    label = f"{family} {kind} (data={shape[0]}, model={shape[1]}){tag}"
    runs, out = {}, {}
    for graphs in ((True, False) if graphs_and_eager else (True,)):
        mode = contextlib.nullcontext() if graphs else compiled.disable_graphs()
        with mode:
            trainer = engine(kind, model, client, config, mesh, device,
                             spmd_kw if kind == "spmd" else seq_kw)
            shared = trainer.client_state if kind == "spmd" else trainer.server_params
            init = {k: v.clone() for k, v in shared.items() if "adapter_1" in k}
            dist.barrier()
            cap0, rep0 = compiled.STATS["captures"], compiled.STATS["replays"]
            t0 = time.perf_counter()
            trainer.run_round(0)
            entry = trainer.evaluate_round(0)
            if device.type == "cuda":
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            shared = trainer.client_state if kind == "spmd" else trainer.server_params
            runs[graphs] = dict(state=state_of(trainer, kind), entry=entry,
                                update={k: (shared[k] - v).float().cpu() for k, v in init.items()})
            out[f"{'graphs' if graphs else 'eager'} round s"] = round(secs, 3)
            if graphs:
                out["captures"] = compiled.STATS["captures"] - cap0
                out["replays"] = compiled.STATS["replays"] - rep0
                params = trainer.backbone if kind == "spmd" else trainer.server_params
                out["bytes"] = tp.backbone_bytes(params)
                call = one_step(trainer, kind, mesh, device)
                with tp.active(ctx), compiled.disable_graphs(), CollectiveCalls() as calls:
                    call()
                per_group = {"model": calls.by_group[mesh.model_group],
                             "data": calls.by_group[mesh.data_group]}
                out["all-reduce calls per eager step"] = per_group
                if device.type == "cuda":
                    stats = {}
                    with tp.active(ctx):
                        busy, nccl = graph_collectives(torch, f"{label} rank {rank}", call,
                                                       nccl_kernels=shape[1] > 1, stats=stats)
                    out["replayed step device ms"] = round(busy, 3)
                    out["NCCL ms"] = round(nccl, 3)
                    # one NCCL kernel per all-reduce over a group of more than one rank
                    want = per_group["model"] + (per_group["data"] if shape[0] > 1 else 0)
                    out["NCCL kernels in the replay"] = stats["nccl_in_replay"]
                    check(stats["nccl_in_replay"] == want,
                          f"{label} rank {rank}: {stats['nccl_in_replay']} NCCL kernels in the "
                          f"replay, {want} all-reduces in an eager step")
            del trainer
    if graphs_and_eager:
        g, e = runs[True], runs[False]
        bad = [k for k, v in g["state"].items() if not torch.equal(v, e["state"][k])]
        check(not bad, f"{label} rank {rank}: the graph round differs from the eager one: {bad[:4]}")
        check(g["entry"] == e["entry"], f"{label} rank {rank}: the histories differ")
    # the model ranks of a slot hold the same replicated partitions
    mine = {k: v for k, v in runs[True]["state"].items()
            if tp.tp_spec_for(k.split("/")[-1], v) is None}
    flat = torch.cat([mine[k].reshape(-1).float() for k in sorted(mine)])
    peers = [torch.empty_like(flat) for _ in range(shape[1])]
    if shape[1] > 1:
        dist.all_gather(peers, flat, group=mesh.model_group)
        check(all(torch.equal(p, flat) for p in peers), f"{label}: the model ranks differ")
    # the host's count against the layers: 2 forward reductions per self-
    # attending layer and 3 per cross-attending one, per encoder pass, and up to
    # 2 (4) backward ones per backward pass
    calls = out["all-reduce calls per eager step"].get("model", 0)
    if shape[1] > 1:
        per_pass = 2 * layers["self"] + 3 * layers["cross"]
        out["model all-reduces per step"] = calls
        out["forward bound (2 passes)"] = 2 * per_pass
        out["backward bound (2 passes)"] = 2 * (2 * layers["self"] + 4 * layers["cross"])
        check(0 < calls <= out["forward bound (2 passes)"] + out["backward bound (2 passes)"],
              f"{label}: {calls} model-group all-reduces per step")
    sizes = [None] * world_size
    dist.all_gather_object(sizes, out)
    if rank == 0:
        print(f"tp cards: {label}: B={b} per client ({b // shape[0]} rows per rank); "
              f"scores {runs[True]['entry']['scores']}", flush=True)
        for r, o in enumerate(sizes):
            print(f"tp cards: {label} rank {r}: {o}", flush=True)
    return out, runs[True]


def hold(family, cross, exact, num_eval):
    """Each tp's graph round (``cross[M]``) against tp = 1 in fp32 by the
    2x-bf16 rule, on every rank (module docstring)."""
    rank = dist.get_rank()
    p, pw, _ = set_error(torch, cross[1]["update"], exact["update"])
    tol = max(TRAIN_GRAD_FACTOR * p, TRAIN_GRAD_FLOOR)
    floor = 100.0 / num_eval  # one example's score
    clients = sorted(exact["entry"]["scores"])
    e_scores = [s for c in clients for s in exact["entry"]["scores"][c]]
    b_scores = [s for c in clients for s in cross[1]["entry"]["scores"][c]]
    check(max(e_scores) > 0, f"{family}: tp=1 fp32 scores are all 0: {e_scores}")
    for m, run in sorted(cross.items()):
        k, kw, kn = set_error(torch, run["update"], exact["update"])
        scores = [s for c in clients for s in run["entry"]["scores"][c]]
        if rank == 0:
            print(f"tp cards: {family} tp={m} adapter_1 update vs tp=1 fp32: {k:.3e} (worst tensor "
                  f"{kw:.3e} {kn}), tp=1 bf16 {p:.3e} (worst tensor {pw:.3e}); tol {tol:.3e}; "
                  f"scores {scores} against fp32 {e_scores}", flush=True)
        check(k <= tol, f"{family} tp={m} rank {rank}: the communicated partition disagrees: "
                        f"{k} > {tol}")
        for i, (a, e, b) in enumerate(zip(scores, e_scores, b_scores)):
            check(abs(a - e) <= max(TRAIN_GRAD_FACTOR * abs(b - e), floor),
                  f"{family} tp={m} rank {rank}: score {i} {a} against fp32 {e} (bf16 tp=1 {b})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--family", default="vilt,albef")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = local_device(args.device)
    with world(device) as size:
        rank = dist.get_rank()
        check(size % 4 == 0, f"a world of {size}: the meshes need 4 ranks")
        if device.type == "cuda" and rank == 0:
            smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 timeout=60, check=True)
            print(smi.stdout.strip().splitlines()[0])
            print(f"torch {torch.__version__} cuda {torch.version.cuda}, a world of {size} over "
                  f"{dist.get_backend()}", flush=True)
        # no warm-up: two steps move the partition by more than bf16's noise
        opt = OptimizerConfig(lr=1e-3, warmup_ratio=0.0)
        config = TrainConfig(peft_mode=PEFTMode.DAT, optimizer=opt,
                             federated=FederatedConfig(comm_rounds=1, local_epochs=1, eval_every=1),
                             num_epochs=1, seed=args.seed)

        def free():
            if device.type == "cuda":
                torch.cuda.empty_cache()

        for family in args.family.split(","):
            t0 = time.perf_counter()
            built = build(family, args.small, device, args.seed)
            if family == "albef":
                config = TrainConfig(encoder_name="albef_no_distill", peft_mode=PEFTMode.DAT,
                                     optimizer=opt, federated=config.federated,
                                     num_epochs=1, seed=args.seed)
            _, tp2 = run_mesh(family, "sequential", (size // 2, 2), built, config, device)
            run_mesh(family, "spmd", (size // 4, 2), built, config, device)
            tag = ""
            if family == "albef":  # the tp = 1, 2, 4 runs with its BERT dropout off
                del built
                free()
                built = build(family, args.small, device, args.seed, dropout=False)
                tag = ", dropout off"
                _, tp2 = run_mesh(family, "sequential", (size // 2, 2), built, config, device,
                                  graphs_and_eager=False, tag=tag)
            cross = {2: tp2}
            for m in (1, 4):
                _, cross[m] = run_mesh(family, "sequential", (size // m, m), built, config, device,
                                       graphs_and_eager=False, tag=tag)
            num_eval = built[-1]
            del built
            free()
            built = build(family, args.small, device, args.seed, "float32", dropout=False)
            _, exact = run_mesh(family, "sequential", (size, 1), built, config, device,
                                graphs_and_eager=False, tag=f"{tag}, fp32")
            del built
            free()
            hold(family, cross, exact, num_eval)
            if rank == 0:
                print(f"tp cards: {family} took {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
