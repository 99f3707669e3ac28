"""Command-line launch surface (counterpart of ``feddat_tpu/cli.py``).

The JAX CLI's flags, with the same names, choices and defaults, so that the
launch scripts under ``scripts/`` run here with ``python -m
feddat_tpu_torch.cli`` in place of ``python -m feddat_tpu.cli``; one flag is
added, ``--device {cuda,cpu}`` (the counterpart of ``JAX_PLATFORMS``; the
default ``cuda`` raises without a card).  A launch ties together the task
registry, the loaders and pipelines, the model, the initial parameters
(random from ``--seed`` or converted from ``--pretrained_model_name``), the
federated engine with round checkpoints and resume, the metrics log, the run
recipe ``meta.json`` and the history JSON, the files the JAX CLI writes,
under the same names:

    <output_dir>/<run>.log, <run>.metrics.jsonl, <run>.history.json
    <checkpoint_dir>/round_NNNNN, meta.json
    <profile_dir>/*.pt.trace.json   (a torch.profiler trace of the first round)

``--engine spmd`` runs ``federated/spmd.py`` over a (client, data) mesh of
ranks, one process per device: started alone it is a world of one (NCCL on
the card, gloo on the CPU); ``torchrun --nproc_per_node N -m
feddat_tpu_torch.cli --engine spmd ...`` runs N ranks, each on
``cuda:LOCAL_RANK``, and ``--multihost`` the same launch across hosts
(``torchrun --nnodes ...``), raising without the launcher's rendezvous.  The
mesh (``--mesh_clients``, default one client per task; ``--mesh_data``,
default the rest of the world) is built before any model, with JAX's errors
(``need N devices, have M``).  Only process 0 writes the metrics log, the
history and ``meta.json``; with more than one process each traces into
``<profile_dir>/proc<rank>``.

``--tp M`` shards the frozen backbone over a ``model`` axis of ranks
(``parallel/tp.py``), one process per rank, as JAX's ``--tp`` shards it over
devices: ``torchrun --nproc_per_node D*M -m feddat_tpu_torch.cli --tp M ...``
runs the sequential engine over a ``(data=D, model=M)`` mesh, and with
``--engine spmd`` over ``(client, data, model)``.  JAX's guards hold
(:func:`apply_tp_arg_guards`): ``--multihost`` is refused, every kernel
route falls back to ``"auto"``, and a batch the data axis does not divide is
refused.  Started alone, ``--tp 2`` raises JAX's mesh error (a world of one
has one device) and never falls back.

Every encoder and every task trainer of the JAX CLI runs: ``vilt`` and
``viltbert`` (ViLT with a frozen BERT in front, ``--bert_model_path`` for its
weights) on the federated VQA clients and on the other trainers' tasks,
VQAv2 5% low-shot, NLVR2, SNLI-VE and VCR (``_build_classification_client``,
each with its task's optimizer settings and epoch horizon; mixed client sets
on the sequential engine, one kind of head on the SPMD engine).  Every
``--attn_impl`` runs ``--dtype float32`` on the card, as every kernel (#1-#9)
takes it.  ``albef_distill`` trains on the sequential engine as in the JAX
CLI: momentum distillation on the plain modes, the fused DAT step without it
(``--use_fused_dat``), a ``TypeError`` at the first step of the standard DAT
step (the distill forward takes the twin, which that step does not pass), and
``NotImplementedError`` with ``--engine spmd`` (JAX raises it once the model
is built; the port, before).

Run: ``python -m feddat_tpu_torch.cli --encoder_name vilt --optimizer_mode dat
--ordered_cl_tasks domain --climb_data_dir ./data ...``
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os
import sys
from typing import Dict

KERNEL_ROUTES = ("block", "layer", "fused", "flash")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("feddat_tpu_torch")
    # reference surface
    p.add_argument("--encoder_name", required=True,
                   choices=["vilt", "viltbert", "albef_distill", "albef_no_distill"])
    p.add_argument("--pretrained_model_name", default=None,
                   help="path to a torch checkpoint (HF ViltModel state dict or ALBEF .pth); omit for random init")
    p.add_argument("--climb_data_dir", default="./data")
    p.add_argument("--output_dir", default="./logs")
    p.add_argument("--do_train", action="store_true")
    p.add_argument("--do_single", action="store_true",
                   help="centralized single-task baseline (reference --do_single)")
    p.add_argument("--optimizer_mode", default="dat",
                   choices=["full", "adapter", "dat", "freeze_encoder",
                            "freeze_bottom_k_layers", "none", "norm", "lora", "bias", "prompt"])
    p.add_argument("--ordered_cl_tasks", default="domain",
                   help="client-set keyword (scene|function|domain) or comma-separated task keys")
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--val_batch_size", type=int, default=None,
                   help="eval-loader batch size (reference flag; its launch scripts pass 2).  "
                        "Default: --batch_size")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--comm_rounds", type=int, default=20)
    p.add_argument("--local_epochs", type=int, default=1)
    p.add_argument("--num_epochs", type=int, default=10)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--adapter_reduction_factor", type=int, default=16)
    p.add_argument("--adapter_config", default="pfeiffer",
                   help="kept for launch-command compatibility (the DAT adapter ignores it, as in the reference)")
    p.add_argument("--splits", nargs="+", default=["train_small", "val", "test_small"])
    p.add_argument("--layers_to_freeze", type=int, default=2)
    p.add_argument("--debug", type=int, default=0)
    p.add_argument("--do_wandb_logging", action="store_true")
    p.add_argument("--wandb_freq", type=int, default=100)
    # the JAX package's additions
    p.add_argument("--engine", default="sequential", choices=["sequential", "spmd"],
                   help="sequential: clients one after another; spmd: one process per "
                        "(client, data) mesh slot (a world of one, or torchrun's ranks)")
    p.add_argument("--multihost", action="store_true",
                   help="a process group across hosts from the launcher's rendezvous (torchrun "
                        "--nnodes) or --coordinator_address/--num_processes/--process_id")
    p.add_argument("--coordinator_address", default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--mesh_clients", type=int, default=None,
                   help="spmd mesh client axis (default: one client per task)")
    p.add_argument("--mesh_data", type=int, default=None,
                   help="spmd mesh data axis (default: the world's ranks over the clients)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree: shard the frozen backbone Megatron-style over a "
                        "`model` axis of ranks (parallel/tp.py); trainable PEFT partitions stay "
                        "replicated.  Sequential engine over (data, model); --engine spmd over "
                        "(client, data, model); one process per rank (torchrun)")
    p.add_argument("--vocab_file", default=None,
                   help="bert-base-uncased vocab.txt for the WordPiece tokenizer")
    p.add_argument("--bert_model_path", default=None,
                   help="torch state dict of a BertModel for the viltbert text half")
    p.add_argument("--eval_every", type=int, default=5)
    p.add_argument("--use_fused_dat", action="store_true",
                   help="the fused DAT step: one ensemble encoder pass per batch")
    p.add_argument("--remat", action="store_true", help="recompute layers in the backward")
    p.add_argument("--remat_policy", default="full",
                   choices=["full", "dots", "attention", "names", "min_save",
                            "block_save", "block_save_nox", "block_save_ffn"],
                   help="what a recomputed layer keeps (ops/remat_policy.py)")
    p.add_argument("--text_remat_policy", default="full", choices=["full", "dots", "names"],
                   help="remat policy of ALBEF's text, fusion and decoder towers")
    p.add_argument("--dropout_rng", default="threefry", choices=["threefry", "rbg"],
                   help="accepted for the launch scripts; both give the same torch generators")
    p.add_argument("--attn_impl", default="auto",
                   choices=["auto", "xla", "fused", "flash", "block", "layer"],
                   help="attention route: auto/xla (composable PyTorch), fused (#5/#6), "
                        "flash (#7-#9), block (#1/#3, frozen projections), layer (#1/#4, the "
                        "whole-layer backward; DAT/adapter modes).  ALBEF: block/layer route its "
                        "ViT.  On the card fused and flash take bf16, block and layer either --dtype")
    p.add_argument("--attention_logits_dtype", default=None, choices=["float32", "bfloat16"],
                   help="storage dtype of attention logits; default bfloat16 with --dtype "
                        "bfloat16, else float32")
    p.add_argument("--num_workers", type=int, default=8,
                   help="host-pipeline decode/resize thread-pool size; 0 = serial loading")
    p.add_argument("--canvas_bucket", action="store_true",
                   help="ViLT pipelines: pad train batches whose every image resizes to "
                        "width <= 384 onto a square (384, 384) canvas")
    p.add_argument("--cache_images", action="store_true",
                   help="cache decoded+resized images (uint8) across epochs/rounds; the "
                        "per-epoch normalize+pad runs in the native core")
    p.add_argument("--spmd_full_epochs", action="store_true",
                   help="spmd: run each round to the largest client's step count (each client "
                        "on its own schedule horizon) instead of the smallest's")
    p.add_argument("--device_normalize", action="store_true",
                   help="ship pixels to the card as raw uint8 and normalize there")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace (CPU and CUDA) of the first executed "
                        "round into this directory")
    p.add_argument("--smoke", action="store_true",
                   help="CI smoke mode: tiny model dimensions + tiny images (functional path only)")
    # the port's addition
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the port runs (the counterpart of JAX_PLATFORMS); cuda raises "
                        "without a card")
    return p


def resolve_task_keys(spec: str):
    from feddat_tpu_torch.configs.tasks import resolve_clients

    if "," in spec:
        return resolve_clients([s.strip() for s in spec.split(",")])
    return resolve_clients(spec)


def refuse_unported(args) -> None:
    """The refusals raised before any model is built or dataset read (the JAX
    CLI's guards, :354-381 and :440-446, stop there too): the port lacks
    nothing the JAX CLI runs, so only JAX's own is left."""
    if args.engine == "spmd" and args.encoder_name == "albef_distill":
        # the JAX CLI's own refusal (cli.py:699-703), which stays after item 12
        raise NotImplementedError(
            "--engine spmd supports albef_no_distill; momentum-distillation aux state is "
            "sequential-engine only (as is the reference's live DAT path, train_albef.sh)")


def check_spmd_args(args) -> None:
    """The JAX CLI's guards of ``--engine spmd`` that need no model (:440-446,
    :679-683), raised before the process group and the mesh."""
    if args.engine != "spmd":
        return
    if args.do_single:
        raise ValueError("--do_single is a per-task centralized baseline with no client axis; "
                         "use --engine sequential for it")
    if args.canvas_bucket:
        raise SystemExit("--canvas_bucket emits per-batch canvases; the spmd engine stacks "
                         "same-shape batches across the client axis.  Use --engine sequential "
                         "with --canvas_bucket.")


def check_attn_args(args) -> None:
    """The JAX CLI's frozen-kernel guard (:416-438): a kernel route with a mode
    that trains what the kernel freezes exits when training and falls back
    to ``"auto"`` for an eval-only run."""
    mode = args.optimizer_mode
    conflict = args.attn_impl in ("block", "layer") and mode in (
        "full", "bias", "lora", "freeze_bottom_k_layers")
    # the whole-layer kernel also freezes the LayerNorms and the FFN
    if args.attn_impl == "layer" and mode == "norm":
        conflict = True
    if conflict:
        if args.do_train:
            raise SystemExit(
                f"--attn_impl {args.attn_impl} assumes a frozen backbone; "
                f"--optimizer_mode {mode} trains part of it (its gradients "
                "would silently be zero).  Use --attn_impl auto for this mode.")
        print(f"[feddat_tpu_torch] --attn_impl {args.attn_impl} is incompatible with "
              f"--optimizer_mode {mode}; falling back to 'auto' for this eval-only run",
              file=sys.stderr)
        args.attn_impl = "auto"
    if args.attn_impl == "layer" and args.remat:
        print("[feddat_tpu_torch] --attn_impl layer: the pre-LN layer stacks save their own "
              "minimal residual set (--remat is ignored for them)", file=sys.stderr)


def apply_tp_arg_guards(args) -> None:
    """Validate/normalize the ``--tp`` argument combinations (in place), as the
    JAX CLI's (:354-381).

    TP composes with both engines — sequential runs over a (data, model)
    mesh (parallel/tp.py), spmd over (client, data, model) — within one
    launcher's world, and with the composable attention route (no CUDA
    kernel partitions over the model axis, as no Pallas kernel does)."""
    if args.tp <= 1:
        return
    if args.multihost:
        raise SystemExit(
            "--tp is single-controller: the sequential engine feeds "
            "process-local batches to the (data, model) mesh, which cannot "
            "span a multihost process group.  Drop --multihost (TP uses all "
            "of this process's devices) or use --engine spmd --multihost "
            "without --tp.")
    if args.attn_impl in KERNEL_ROUTES:
        print(f"[feddat_tpu_torch] --attn_impl {args.attn_impl} is a Pallas custom "
              "call and does not partition over the model axis; falling back "
              "to 'auto' for this --tp run", file=sys.stderr)
        args.attn_impl = "auto"


def check_tp_batch(args, tp_mesh) -> None:
    """The JAX CLI's batch check under ``--tp`` (:787-798)."""
    dp = tp_mesh.shape["data"]
    if args.batch_size % dp != 0:
        raise SystemExit(
            f"--batch_size {args.batch_size} is not divisible by the "
            f"TP mesh's data axis ({dp} = {dp * args.tp} devices / "
            f"--tp {args.tp}); batches are sharded over that axis")


def _build_vqa_cross_client(args, key, spec, tokenizer, answer_banks):
    """Federated cross-VQA client (the reference's ``VQATrainerCross`` data
    path, ``train_vqa_crossvqa.py:39-230``)."""
    from feddat_tpu_torch.data.albef_pipeline import AlbefVQAPipeline
    from feddat_tpu_torch.data.datasets import load_ans2label, load_examples
    from feddat_tpu_torch.data.images import make_backend
    from feddat_tpu_torch.data.pipeline import ViltVQAPipeline

    # every task path roots under --climb_data_dir (``train_vqa_crossvqa.py:
    # 97-98``); a registered task with an absolute data_dir passes through
    data_dir = os.path.join(args.climb_data_dir, spec.data_dir)
    train_split, eval_split = args.splits[0], args.splits[-1]
    examples = load_examples(key, data_dir, train_split, data_root=args.climb_data_dir,
                             tokenizer=tokenizer, shuffle_seed=args.seed)
    eval_examples = None
    if eval_split != train_split:
        try:
            eval_examples = load_examples(key, data_dir, eval_split, data_root=args.climb_data_dir,
                                          tokenizer=tokenizer)
        except (FileNotFoundError, OSError) as e:
            # dev fixtures without an eval split evaluate on train, never silently
            logging.getLogger("feddat_tpu_torch").warning(
                "task %s: no %r split found (%s); evaluating on the TRAIN split", key, eval_split, e)
    backend = make_backend(spec.images_source, key, args.climb_data_dir)
    if args.encoder_name.startswith("albef"):
        ans2label = load_ans2label(key, data_dir, args.climb_data_dir)
        answer_list = list(ans2label.keys())[:100]  # vqa_dataset_crossvqa.py:301
        pipe = AlbefVQAPipeline(
            examples, backend, tokenizer, answer_list,
            batch_size=args.batch_size, val_batch_size=args.val_batch_size,
            seed=args.seed, eval_examples=eval_examples,
            cache_images=args.cache_images, pixels_u8=args.device_normalize,
            num_workers=args.num_workers,
            **({"image_size": 64, "max_question_len": 12, "max_answer_len": 6}
               if args.smoke else {}),
        )
        answer_banks[key] = (pipe.answer_ids, pipe.answer_mask)
        return pipe
    return ViltVQAPipeline(
        examples, backend, tokenizer,
        num_labels=spec.num_labels, batch_size=args.batch_size,
        val_batch_size=args.val_batch_size, seed=args.seed,
        eval_examples=eval_examples, cache_images=args.cache_images,
        pixels_u8=args.device_normalize, num_workers=args.num_workers,
        canvas_bucket=args.canvas_bucket,
        **({"canvas": (64, 64), "max_text_len": 16} if args.smoke else {}),
    )


def _build_classification_client(args, key, spec, tokenizer):
    """The non-federated VL tasks through their reference trainers' data
    paths (:241-328): VQAv2 5% low-shot (``train_vqa.py:70-71``), NLVR2
    2048/256 per class with the batch halved (``train_nlvr2.py:91-92``,
    ``nlvr2_dataset.py:170``), SNLI-VE 2048/256 per class over train/dev
    (``train_snli_ve.py:99-100``), VCR 5% low-shot ``qa`` (``train_vcr.py:94-95``)."""
    from feddat_tpu_torch.data.classification_datasets import (
        Nlvr2Pipeline,
        SnliVePipeline,
        VcrPipeline,
        convert_to_low_shot_per_class,
        load_nlvr2_examples,
        load_snli_ve_examples,
        load_vcr_examples,
    )
    from feddat_tpu_torch.data.datasets import convert_to_low_shot, load_vqav2_examples
    from feddat_tpu_torch.data.images import make_backend
    from feddat_tpu_torch.data.pipeline import ViltVQAPipeline

    data_dir = os.path.join(args.climb_data_dir, spec.data_dir)
    if (args.cache_images or args.device_normalize or args.canvas_bucket) and spec.trainer != "vqa":
        print(f"[feddat_tpu_torch] --cache_images/--device_normalize/--canvas_bucket are not wired "
              f"into the {spec.trainer!r} pipeline; task {key!r} uses the plain f32 full-canvas "
              "image path", file=sys.stderr)
    smoke_kw = {"canvas": (64, 64), "max_text_len": 16} if args.smoke else {}
    canvas = smoke_kw.get("canvas", (384, 640))
    max_text_len = smoke_kw.get("max_text_len", 40)

    if spec.trainer == "vqa":
        # the reference's fixed low-shot seed (random.Random(1),
        # vqa_dataset.py:181), whatever --seed says
        ex = convert_to_low_shot(load_vqav2_examples(data_dir, "train", tokenizer), 0.05, seed=1)
        ev = convert_to_low_shot(load_vqav2_examples(data_dir, "val", tokenizer), 0.05, seed=1)
        return ViltVQAPipeline(
            ex, make_backend(spec.images_source, key, args.climb_data_dir), tokenizer,
            num_labels=spec.num_labels, batch_size=args.batch_size,
            val_batch_size=args.val_batch_size, seed=args.seed, eval_examples=ev,
            cache_images=args.cache_images, pixels_u8=args.device_normalize,
            num_workers=args.num_workers, canvas_bucket=args.canvas_bucket, **smoke_kw)
    if spec.trainer == "nlvr2":
        ex = convert_to_low_shot_per_class(load_nlvr2_examples(data_dir, "train"),
                                           spec.num_labels, 2048, seed=1)
        ev = convert_to_low_shot_per_class(load_nlvr2_examples(data_dir, "val"),
                                           spec.num_labels, 256, seed=1)
        return Nlvr2Pipeline(
            ex, tokenizer, max_text_len, canvas, batch_size=max(1, args.batch_size // 2),
            val_batch_size=max(1, args.val_batch_size // 2) if args.val_batch_size else None,
            seed=args.seed, eval_examples=ev)
    if spec.trainer == "snli_ve":
        ex = convert_to_low_shot_per_class(load_snli_ve_examples(data_dir, "train"),
                                           spec.num_labels, 2048, seed=1)
        ev = convert_to_low_shot_per_class(load_snli_ve_examples(data_dir, "dev"),
                                           spec.num_labels, 256, seed=1)
        return SnliVePipeline(
            ex, make_backend(spec.images_source, key, args.climb_data_dir), tokenizer,
            max_text_len, canvas, batch_size=args.batch_size,
            val_batch_size=args.val_batch_size, seed=args.seed, eval_examples=ev)
    if spec.trainer == "vcr":
        ex = convert_to_low_shot(load_vcr_examples(data_dir, "train", "qa"), 0.05, seed=1)
        ev = convert_to_low_shot(load_vcr_examples(data_dir, "val", "qa"), 0.05, seed=1)
        return VcrPipeline(
            ex, tokenizer, max_text_len, canvas, batch_size=args.batch_size,
            val_batch_size=args.val_batch_size, num_choices=spec.num_choices, seed=args.seed,
            image_root=data_dir, eval_examples=ev)
    raise KeyError(f"unknown trainer kind {spec.trainer!r} for task {key!r}")


def build_clients(args, task_keys, tokenizer):
    """Per-client data pipelines routed by ``TaskSpec.trainer`` (the
    reference's ``task_configs[task_key]['task_trainer']``,
    ``src/train/main.py:482-483``) -> (clients, answer_banks)."""
    from feddat_tpu_torch.configs.tasks import TASK_CONFIGS

    clients, answer_banks = {}, {}
    for key in task_keys:
        spec = TASK_CONFIGS[key]
        if spec.trainer == "vqa_cross":
            pipe = _build_vqa_cross_client(args, key, spec, tokenizer, answer_banks)
        else:
            if args.encoder_name.startswith("albef"):
                raise NotImplementedError(
                    f"task {key!r} ({spec.trainer}) is a ViLT-family task; "
                    "the reference has no ALBEF path for it either")
            pipe = _build_classification_client(args, key, spec, tokenizer)
        pipe.task_key = key
        clients[key] = pipe
    return clients, answer_banks


def image_path(pipe) -> str:
    """How a client's pipeline makes its pixels (logged per client)."""
    if getattr(pipe, "_cache", None) is None:
        return "decoded per batch"
    if pipe.pixels_u8:
        return "u8 cache, normalized on the card"
    if pipe._native_finalize is not None:
        return "u8 cache, finalized by the native core"
    return "u8 cache, finalized by numpy"


def build_model(args, mode, heads, device):
    """-> (model, model_config, attention logits dtype or None under
    ``--smoke``).  The smoke models are the JAX CLI's (:513-556): float32 on
    the composable route whatever ``--dtype`` and ``--attn_impl`` say."""
    import torch

    from feddat_tpu_torch.configs.core import LoraSpec, PromptSpec, PEFTMode, adapter_spec_for_mode

    smoke_lora = LoraSpec(rank=2, enabled=(mode == PEFTMode.LORA))
    smoke_prompt = PromptSpec(length=2, bottleneck=8, enabled=(mode == PEFTMode.PROMPT))
    if args.smoke and args.encoder_name.startswith("albef"):
        from feddat_tpu_torch.configs.core import AlbefBertConfig, AlbefModelConfig
        from feddat_tpu_torch.models.albef import AlbefModel

        # encoder_width: the ViT's width, which flax infers at init and the
        # port's cross-attention is built with
        smoke_bert = AlbefBertConfig(
            hidden_size=32, num_layers=4, num_heads=4, intermediate_size=64,
            hidden_dropout=0.0, attention_dropout=0.0, fusion_layer=2, encoder_width=32,
        )
        cfg = AlbefModelConfig(
            image_res=64, patch_size=32, vision_width=32, vision_layers=2,
            vision_heads=4, bert=smoke_bert, decoder_layers=2,
            adapter=adapter_spec_for_mode(mode, 4), lora=smoke_lora, prompt=smoke_prompt,
        )
        with torch.device("meta"):
            model = AlbefModel(cfg)
        return model.to_empty(device=device), cfg, None
    if args.smoke:
        from feddat_tpu_torch.configs.core import ViltModelConfig
        from feddat_tpu_torch.models.vilt import ViltContinualLearner
        from feddat_tpu_torch.models.viltbert import ViltBertContinualLearner

        cfg = ViltModelConfig(
            hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
            max_text_len=16, image_size=(64, 64), patch_size=32,
            adapter=adapter_spec_for_mode(mode, 4), lora=smoke_lora, prompt=smoke_prompt,
        )
        cls = ViltBertContinualLearner if args.encoder_name == "viltbert" else ViltContinualLearner
        with torch.device("meta"):
            model = cls(cfg, heads)
        return model.to_empty(device=device), cfg, None
    from feddat_tpu_torch.models import create_model

    logits_dtype = args.attention_logits_dtype or (
        "bfloat16" if args.dtype == "bfloat16" else "float32")
    # ViLT matches the pipeline's fixed (384, 640) canvas
    model, cfg = create_model(
        args.encoder_name, heads, mode, args.adapter_reduction_factor, args.dtype,
        image_size=(384, 640) if args.encoder_name in ("vilt", "viltbert") else None,
        remat=args.remat, remat_policy=args.remat_policy,
        attn_impl=args.attn_impl, attention_logits_dtype=logits_dtype,
        text_remat_policy=args.text_remat_policy, device=device, seed=args.seed,
    )
    return model, cfg, logits_dtype


def init_params(args, model, model_cfg) -> Dict[str, "torch.Tensor"]:
    """The run's initial parameters ``{state_dict name: tensor}``: the model's
    own weights from ``--seed`` (``create_model``'s, or ``init_vilt_params``/
    ``init_albef_params`` under ``--smoke``), with ``--pretrained_model_name``
    converted and merged over them (:569-614), and for ``viltbert`` the
    ``--bert_model_path`` BertModel state dict converted to the text BERT
    (:584-596)."""
    import torch

    from feddat_tpu_torch.utils.checkpoint_convert import merge_pretrained

    albef = args.encoder_name.startswith("albef")
    if args.smoke:
        from feddat_tpu_torch.models.albef import init_albef_params
        from feddat_tpu_torch.models.vilt import init_vilt_params

        (init_albef_params if albef else init_vilt_params)(model, args.seed)
    params = {k: v.detach() for k, v in model.state_dict().items()}
    if not args.pretrained_model_name:
        return _merge_text_bert(args, params, model_cfg)
    raw = torch.load(args.pretrained_model_name, map_location="cpu")
    if albef:
        from feddat_tpu_torch.utils.checkpoint_convert import convert_albef_checkpoint
        from feddat_tpu_torch.utils.param_bridge import albef_from_flax

        n_patches = (model_cfg.image_res // model_cfg.patch_size) ** 2
        pretrained = convert_albef_checkpoint(raw.get("model", raw), num_patches_new=n_patches)
        return merge_pretrained(params, pretrained, bridge=albef_from_flax)
    from feddat_tpu_torch.utils.checkpoint_convert import convert_hf_vilt

    grid = (model_cfg.image_size[0] // model_cfg.patch_size,
            model_cfg.image_size[1] // model_cfg.patch_size)
    pretrained = convert_hf_vilt(raw, num_layers=model_cfg.num_layers, num_patches_new=grid)
    return _merge_text_bert(args, merge_pretrained(params, {"vilt": pretrained}), model_cfg)


def _merge_text_bert(args, params, model_cfg):
    """``--bert_model_path`` (viltbert): a BertModel state dict converted to an
    ``XBertModel`` without fusion layers and merged into ``text_bert``."""
    if args.encoder_name != "viltbert" or not args.bert_model_path:
        return params
    import torch

    from feddat_tpu_torch.utils.checkpoint_convert import convert_bert_to_xbert, merge_pretrained
    from feddat_tpu_torch.utils.param_bridge import viltbert_from_flax

    bert = convert_bert_to_xbert(torch.load(args.bert_model_path, map_location="cpu"),
                                 num_layers=model_cfg.num_layers, fusion_layer=model_cfg.num_layers)
    return merge_pretrained(params, {"text_bert": bert}, bridge=viltbert_from_flax)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    task_keys = resolve_task_keys(args.ordered_cl_tasks)
    check_attn_args(args)
    apply_tp_arg_guards(args)
    refuse_unported(args)
    check_spmd_args(args)

    from feddat_tpu_torch.device import resolve_device
    from feddat_tpu_torch.parallel import mesh as pmesh
    from feddat_tpu_torch.parallel.tp import make_tp_mesh

    device = resolve_device(args.device)
    with contextlib.ExitStack() as stack:
        mesh = None
        if args.engine == "spmd" or args.multihost or args.tp > 1:
            device = pmesh.local_device(device.type)  # cuda:LOCAL_RANK
            if args.multihost:
                pmesh.initialize_multihost(args.coordinator_address, args.num_processes,
                                           args.process_id, device)
            stack.enter_context(pmesh.world(device))
        # JAX's mesh errors come before any model
        if args.engine == "spmd" and args.multihost:
            mesh = pmesh.make_multihost_mesh(num_clients=args.mesh_clients or len(task_keys),
                                             data_parallel=args.mesh_data, device_type=device.type)
        elif args.engine == "spmd":
            mesh = pmesh.make_mesh(num_clients=args.mesh_clients or len(task_keys),
                                   data_parallel=args.mesh_data, model_parallel=args.tp,
                                   device_type=device.type)
        elif args.tp > 1:
            mesh = make_tp_mesh(model_parallel=args.tp, device_type=device.type)
            check_tp_batch(args, mesh)
        return _run(args, task_keys, device, mesh)


def train_config(args, task_keys):
    """The run's ``TrainConfig`` from its flags (:448-467)."""
    from feddat_tpu_torch.configs.core import (
        FederatedConfig,
        OptimizerConfig,
        PEFTMode,
        TrainConfig,
    )

    return TrainConfig(
        encoder_name=args.encoder_name,
        peft_mode=PEFTMode(args.optimizer_mode),
        tasks=tuple(task_keys),
        batch_size=args.batch_size,
        val_batch_size=args.val_batch_size or args.batch_size,
        seed=args.seed,
        optimizer=OptimizerConfig(lr=args.lr),
        federated=FederatedConfig(
            comm_rounds=args.comm_rounds,
            local_epochs=args.local_epochs,
            eval_every=args.eval_every,
        ),
        num_epochs=args.num_epochs,
        layers_to_freeze=args.layers_to_freeze,
        dtype=args.dtype,
        single_task=args.do_single,
        debug_steps=args.debug,
        dropout_rng=args.dropout_rng,
    )


def task_overrides(task_keys):
    """-> (optimizer, epoch) overrides by task: the non-federated tasks take
    lr/wd/eps/warmup and their schedule's horizon from the task config
    (``train_nlvr2.py:85-97``, :657-676); the federated cross-VQA clients
    take ``--lr`` and ``--num_epochs``."""
    from feddat_tpu_torch.configs.core import OptimizerConfig
    from feddat_tpu_torch.configs.tasks import TASK_CONFIGS

    specs = {k: TASK_CONFIGS[k] for k in task_keys if TASK_CONFIGS[k].trainer != "vqa_cross"}
    return ({k: OptimizerConfig(lr=s.lr, weight_decay=s.weight_decay, adam_eps=s.adam_epsilon,
                                warmup_ratio=s.warmup_ratio) for k, s in specs.items()},
            {k: s.num_epochs for k, s in specs.items()})


def sequential_trainer(args, task_keys, model, params, clients, answer_banks, config, device,
                       metrics=None, tp_mesh=None):
    """The sequential ``FederatedTrainer`` a launch runs (:753-800): each
    client's forward, eval step and metric from its task's trainer hooks (a
    mixed client set in one run), the per-task overrides, and the fused DAT
    step only where every task is a VQA-family one."""
    from feddat_tpu_torch.configs.tasks import TASK_CONFIGS
    from feddat_tpu_torch.federated.engine import FederatedTrainer
    from feddat_tpu_torch.train.evaluation import make_eval_step
    from feddat_tpu_torch.train.trainers import resolve_trainer

    def hooks_for(task_key):
        return resolve_trainer(args.encoder_name, TASK_CONFIGS[task_key].trainer,
                               answer_banks=answer_banks)

    def make_eval(model_, task_key):
        h = hooks_for(task_key)
        if h.make_eval is not None:
            return h.make_eval(model_, task_key)
        return make_eval_step(model_, task_key, h.metric)

    first_hooks = hooks_for(task_keys[0])
    use_fused = args.use_fused_dat
    if use_fused and {TASK_CONFIGS[k].trainer for k in task_keys} - {"vqa_cross", "vqa"}:
        logging.getLogger("feddat_tpu_torch").warning(
            "--use_fused_dat covers the VQA-family losses (BCE single-image); classification "
            "tasks use the standard DAT step")
        use_fused = False
    opt_overrides, epoch_overrides = task_overrides(task_keys)
    profile_dir = args.profile_dir
    if profile_dir and tp_mesh is not None and tp_mesh.grid.size > 1:  # one subtree per process
        profile_dir = os.path.join(profile_dir, f"proc{tp_mesh.rank}")
    return FederatedTrainer(
        model, params, clients, config,
        make_forward=lambda model_, task_key: hooks_for(task_key).make_forward(model_, task_key),
        make_eval=make_eval,
        metric=first_hooks.metric,
        aux_init=first_hooks.aux_init,
        batch_transform=first_hooks.batch_transform,
        aux_forward=first_hooks.aux_forward,
        use_fused_dat=use_fused,
        optimizer_overrides=opt_overrides,
        num_epochs_overrides=epoch_overrides,
        checkpoint_dir=args.checkpoint_dir, metrics_logger=metrics,
        tp_mesh=tp_mesh,
        profile_dir=profile_dir,
        device=device,
    )


def _run(args, task_keys, device, mesh) -> int:
    """The launch after the refusals, on ``device``, with the SPMD engine's
    ``mesh``, the sequential engine's ``(data, model)`` mesh under ``--tp``,
    or None."""
    from feddat_tpu_torch import native
    from feddat_tpu_torch.configs.core import PEFTMode
    from feddat_tpu_torch.configs.tasks import TASK_CONFIGS
    from feddat_tpu_torch.models.vilt import TaskHeadSpec
    from feddat_tpu_torch.utils.observability import MetricsLogger, experiment_name, setup_logger
    from feddat_tpu_torch.utils.seeding import process_index

    mode = PEFTMode(args.optimizer_mode)
    config = train_config(args, task_keys)
    run_name = experiment_name(config)
    logger = setup_logger(args.output_dir, run_name=run_name)
    logger.info("tasks: %s", task_keys)

    from feddat_tpu_torch.data.tokenizer import WordPieceTokenizer

    logger.info("native host core: %s", "available" if native.available() else "unavailable")
    if args.vocab_file:
        tokenizer = WordPieceTokenizer.from_vocab_file(args.vocab_file)
        if native.available():  # the GIL-free C++ batch tokenizer
            tokenizer = native.NativeWordPiece(tokenizer.vocab)
            logger.info("using native C++ WordPiece tokenizer")
    else:
        logger.warning("no --vocab_file given; using a toy tokenizer (tests/dev only)")
        tokenizer = WordPieceTokenizer.toy(["what", "is", "the", "a"])

    def head_spec(key):
        spec = TASK_CONFIGS[key]
        return TaskHeadSpec(num_labels=spec.num_labels, num_images=spec.num_images,
                            model_type=spec.model_type, num_choices=spec.num_choices)

    if args.engine == "spmd":
        # the SPMD clients share one head module, task_<FED_HEAD_KEY>
        from feddat_tpu_torch.federated.spmd import FED_HEAD_KEY

        specs = {head_spec(k) for k in task_keys}
        if len(specs) != 1:
            raise ValueError(f"--engine spmd needs a uniform head shape across clients; got {specs}")
        heads = {FED_HEAD_KEY: next(iter(specs))}
    else:
        heads = {k: head_spec(k) for k in task_keys}
    model, model_cfg, logits_dtype = build_model(args, mode, heads, device)
    clients, answer_banks = build_clients(args, task_keys, tokenizer)
    for key, pipe in clients.items():
        logger.info("client %s: %d train / %d eval examples; images: %s", key,
                    pipe.num_train_examples, pipe.num_eval_examples, image_path(pipe))
    params = init_params(args, model, model_cfg)

    # single writer: only process 0 writes the JSONL / W&B stream
    is_p0 = process_index() == 0
    metrics = MetricsLogger(
        os.path.join(args.output_dir, f"{run_name}.metrics.jsonl") if is_p0 else None,
        log_every=args.wandb_freq,
        wandb_project="feddat_tpu" if (args.do_wandb_logging and is_p0) else None,
        wandb_run_name=run_name,
    )
    if args.checkpoint_dir and is_p0:
        # the run's model recipe beside the round checkpoints, for
        # serving.*.from_checkpoint; the JAX CLI's keys and values
        from feddat_tpu_torch.utils.checkpointing import write_meta

        meta = {
            "encoder_name": args.encoder_name,
            "optimizer_mode": args.optimizer_mode,
            "adapter_reduction_factor": args.adapter_reduction_factor,
            "dtype": args.dtype,
            "engine": args.engine,
            "tasks": list(task_keys),
            "smoke": bool(args.smoke),
            "image_size": [384, 640] if args.encoder_name in ("vilt", "viltbert") else None,
            "attention_logits_dtype": logits_dtype,
            "heads": {k: dataclasses.asdict(head_spec(k)) for k in task_keys},
        }
        if args.encoder_name.startswith("albef"):
            meta["answer_lists"] = {k: list(clients[k].answer_list) for k in task_keys}
        write_meta(args.checkpoint_dir, meta)

    if args.engine == "spmd":
        from feddat_tpu_torch.federated.spmd import SPMDFederatedTrainer
        from feddat_tpu_torch.train.forwards import make_vilt_forward

        opt_overrides, epoch_overrides = task_overrides(task_keys)
        is_albef = args.encoder_name.startswith("albef")
        is_classification = bool({TASK_CONFIGS[k].trainer for k in task_keys}
                                 & {"nlvr2", "snli_ve", "vcr"})
        use_fused = args.use_fused_dat
        if use_fused and is_classification:
            logger.warning("--use_fused_dat covers the VQA-family losses; classification tasks "
                           "use the standard DAT step")
            use_fused = False
        make_forward = None
        if is_classification and not is_albef:
            make_forward = lambda m, k: make_vilt_forward(m, k, loss="ce")  # noqa: E731
        # one step program for every client: the task-config override holds
        # when all clients agree on it, as in JAX (:735-751)
        if opt_overrides:
            if set(opt_overrides) != set(task_keys) or len({
                (o.lr, o.weight_decay, o.adam_eps, o.warmup_ratio) for o in opt_overrides.values()
            }) != 1 or len(set(epoch_overrides.values())) != 1:
                raise SystemExit(
                    "--engine spmd compiles one optimizer for all clients, but the selected tasks "
                    "carry different per-task optimizer configs; use --engine sequential for "
                    "mixed task kinds")
            config = dataclasses.replace(config, optimizer=next(iter(opt_overrides.values())),
                                         num_epochs=next(iter(epoch_overrides.values())))
        profile_dir = args.profile_dir
        if profile_dir and mesh.grid.size > 1:  # one trace subtree per process
            profile_dir = os.path.join(profile_dir, f"proc{mesh.rank}")
        trainer = SPMDFederatedTrainer(
            model, params, [clients[k] for k in task_keys], config, mesh,
            make_forward=make_forward, use_fused=use_fused, checkpoint_dir=args.checkpoint_dir,
            metrics_logger=metrics, family="albef" if is_albef else "vilt",
            answer_banks=answer_banks if is_albef else None,
            metric="accuracy" if is_classification else "vqa_score",
            full_epochs=args.spmd_full_epochs, profile_dir=profile_dir, device=device)
        history = trainer.run()
    else:
        if mesh is not None:
            logger.info("tensor parallel: mesh (data=%d, model=%d)", mesh.shape["data"],
                        mesh.shape["model"])
        trainer = sequential_trainer(args, task_keys, model, params, clients, answer_banks, config,
                                     device, metrics, tp_mesh=mesh)
        history = [trainer.run_single_task()] if args.do_single else trainer.run()
    metrics.close()
    if device.type == "cuda":
        from feddat_tpu_torch.ops._build import KERNELS
        from feddat_tpu_torch.train.compiled import STATS

        logger.info("kernel launches: %s; graphs: %s",
                    {k.symbol: k.launches for k in KERNELS if k.launches}, STATS)
    if is_p0:  # single writer on shared filesystems
        out = os.path.join(args.output_dir, f"{run_name}.history.json")
        os.makedirs(args.output_dir, exist_ok=True)
        with open(out, "w") as f:
            json.dump(history, f, indent=2, default=float)
        logger.info("history written to %s", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
