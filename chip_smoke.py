"""Drive the PyTorch/CUDA port (``feddat_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, in this order:

1. build  — compile every kernel source in ``feddat_tpu_torch/csrc`` (one
            ``nvcc`` per source, all at once) and print the build time.
2. parity — hold each kernel against its plain PyTorch version on the card, at
            the serving and training shapes and at ragged ones, with the stated
            tolerances; the attention-block forward (#1) and backward (#3) and
            the whole-layer backward (#4) also at M = 127, 128, 129 and 257 rows
            (the edges of their GEMM's 128-row tiles) and at the accuracy
            study's step (B=32, S=77: phase 17 on "block", #4 on the study's
            "layer" route), each twice, bitwise, #1's
            q/k/v plane bitwise against #3's recompute of it; the flash
            forward (#7) at ALBEF's nine attention shapes, eight tile edges and
            the prompt's fusion cross-attention (577 + 5 keys), twice, bitwise;
            the flash backward (#8 dq, #9 dk/dv) at ALBEF's five training
            sites, four ragged shapes, twelve tile edges and the prompt's
            fusion cross-attention, twice,
            bitwise, with constructed probes of p's and ds's precision and the
            wrappers' refusals; #1 and #3 (LN1 outside) and #4 at ALBEF's ViT
            length S=577 without a padding bias and at S=592, 593 and 768;
            #1 and #3 (LN1 fused and outside) and #4 (both adapter modes)
            past 768, at B=2, S=769 and B=1, S=1024;
            the whole-sequence attention (#5, #6) at five shapes, the 64-row tile edges, S=769 and 1024 and a fully masked
            batch element, twice, bitwise, with constructed probes of its bf16
            rounding points (P before P.v, ds before dq and dk); the
            ensemble-adapter epilogue (#2) at ten row counts (the edges of its
            64-row cluster tiles, the B=1 bucket, the serving batch) for
            bottlenecks 48, 12 and 96, twice, bitwise, with a planted fault
            and a constructed probe of the ReLU output's low bits, and at
            five row counts for bottlenecks 192, 384 and 196 (walked in
            chunks) and widths 1280 (R=80) and 2048 (R=128), with the probe
            again at R=192 in the second chunk; #1 and #4
            (both adapter modes) at the from-disk training shape, B=64, S=281,
            on the key mask of the phase 12 dataset's first batch (padded
            canvases and text).
3. serve  — full-width ViLT-B/32 DAT in bf16 (attn_impl='block', fused LN, fused
            ensemble adapter, random weights from --seed, a 3129-label VQA head)
            behind ``ViltVqaPredictor.predict``: a batch request and a single one.
            Launch counts are read around exactly this run, and the probabilities
            are held against the port's plain path (attn_impl='auto').
4. train  — full-width ViLT-B/32 DAT training in bf16 at B=64, canvas 384x384
            (S=185), attn_impl='layer': fused DAT steps with launch counts read
            around one step (#1 and #4 once per layer per pass); the first step's
            losses and gradients held against the port's plain path; the standard
            DAT step with attn_impl='block' (#3); then one FederatedTrainer round
            of two synthetic clients with FedAvg of adapter_1 and evaluate_dat.
5. peft   — the single-update PEFT baselines at the same width and batch through
            attn_impl='fused' (a 100-label head as scripts/peft_bench.py): one
            plain train step each of lora (r=16 on q/v, lora_b drawn non-zero),
            bias, full, prompt (S=195) and freeze_bottom_k_layers (k=2) with the
            #5/#6 launches read around it (12/12, 12/10 with k=2), gradients held
            against the plain path in fp32 by the 2x-bf16 rule; then one
            FederatedTrainer round of LoRA (2 clients x 2 steps, FedAvg of the
            LoRA factors) and its evaluation (#5 only).
6. albef  — full-width ALBEF (ViT-B/16 at 384 px, S=577; BERT-base text and
            fusion encoder; 6-layer decoder; vocabulary 30522) DAT in bf16 with
            attn_impl='flash' behind ``AlbefVqaPredictor.predict`` over a
            100-answer bank, k=64, rerank packed 8 per row: one B=16 request
            batch and one single request, #7 launched 54 times per
            rank_answer.  Question states and stage-1 logits held against the
            plain path (attn_impl='auto') in fp32 by the 2x-bf16 rule, and
            the top-1 answers against it.
7. time   — each kernel, its plain version and one PyTorch call (chain) for the
            same function (a yardstick the port never calls), by the profiler's
            device time (``device_ms``; the CUDA-event wall per call beside it),
            against the kernel's bound (#1 at the serving and training shapes,
            #2 at the serving batch and the B=1 bucket, and at the serving
            batch for R=192 and 384 and D=1280 and 2048; #1, #3 and #4 at
            B=16, S=769 and 1024);
            the device time of each launch of one #1 call at both shapes and of
            one #2, one #3 and one #4 call, and #4's FFN products on the wgmma GEMM beside
            cuBLAS's torch.mm at the same shapes; serving rates and latency; DAT and LoRA
            train samples/s and ALBEF rank-answer questions/s, kernel path
            against plain path in alternating samples; torch.profiler
            breakdowns of one serving forward, one step of each and one
            rank_answer call.  Then the earlier phases' models are freed.
8. albef_train — full-width ALBEF DAT training, bf16, attn_impl='flash', the
            fused DAT step at B=48 questions x 4 answers (bench.py's batch):
            (a) dropout 0.1 live, #7/#8/#9 launches read around one step (the
            ViT sites only), steps repeated from one state give equal losses
            and another generator seed other ones; (b) dropout off, launches
            at every site, and the four gradient sets and both losses held
            against the plain fp32 path by the 2x-bf16 rule at B=48; (c) one
            FederatedTrainer round of two synthetic ALBEF clients (2 fused
            steps each, FedAvg of adapter_1) and evaluate_dat by rank_answer.
9. time   — #8 and #9 at ALBEF's ViT shape beside the plain backward, autograd
            through SDPA and their bounds, by device time; ALBEF train
            samples/s, kernel path against plain path, with peak memory; a
            profile of one step.
10. graphs — phases 2-9 run under ``disable_graphs()``, the eager path; this
            one drives the compiled layer (``feddat_tpu_torch/train/compiled.py``)
            through the entry points users call, as CUDA graphs: the fused DAT
            step ('layer'), the ViLT eval step (3 DAT modes), the standard DAT
            step ('block'), the LoRA step ('fused'), ViltVqaPredictor.forward
            (two request batches into one graph: #2's TMA maps hold the
            capture's addresses), AlbefVqaPredictor.rank, the fused ALBEF step
            with dropout live and the ALBEF eval step (2 modes), each: launches
            per replay, counted by the wrappers and measured from the device's
            kernel names in a profile, equal to the eager path's per call,
            two replayed calls
            bitwise equal to two eager ones (or within twice eager's own
            run-to-run spread where eager is not bitwise run to run), then graph
            against eager in one pair (host launch calls, wall, device
            busy, idle share, peak memory; a replay launches no kernel but its
            copies, generator fills and one graph, and runs the eager call's
            kernels); ALBEF replays from one state equal, from another seed
            not; FederatedTrainers of two ALBEF clients (one shared train
            program, one shared eval program) and of two ViLT clients (a train
            and an eval program each) over one round and evaluate_dat, bitwise
            equal to the eager engines; then the routing gate: #4's limit
            against the library's, a 'layer' DAT step at adapter bottleneck 96
            through #1/#3 (not #4) by the 2x-bf16 rule; then past the first
            designs' limits: full-width ViLT-B/32 DAT at reduction 4
            (bottleneck 192), the fused ensemble adapter, 'block' with
            fuse_ln, on a canvas of 832x896 (S=769), B=16: two standard DAT
            steps (#1 36, #3 22, #2 24 each; the first's gradients by the
            2x-bf16 rule) and ViltVqaPredictor's ensemble forward (#1 12, #2
            12) by the serving rule.
11. albef_tuned — the JAX package's tuned ALBEF configuration (bench.py:192-229):
            full-width ALBEF DAT in bf16 through create_model(attn_impl='layer',
            remat=True, remat_policy='block_save_nox', text_remat_policy='names',
            attention_logits_dtype='bfloat16'): the ViT on #1/#4 at S=577, the
            BERT towers on the composable path with "names" remat.  The fused
            DAT step at B=48 x 4: dropout off, launches 24/24 and the 2x-bf16
            rule against the plain path; dropout live, remat against no remat
            bitwise with each one's peak memory; a replay bitwise an eager
            step, launches per replay from the wrappers and from the
            device, graph against eager in one pair and a profile of one replay;
            samples/s and peak memory of the tuned and "flash" paths with
            graphs, one after another; a 2-client round of one step each,
            eager against graphs;
            the "block" route with block_save_nox at B=16 (#1 24, #3 22 per
            step; "full" runs #1 again in the backward), bitwise against no
            remat and "full"; #1, #3 and #4 timed at S=577.
12. from_disk — the path from files to answers.  A dataset written at the
            start from --seed in the reference's on-disk layout (two
            registered tasks whose image backends differ, vizwiz and gqa;
            per client 128 train and 64 eval questions of 10 answers on JPEGs
            of mixed size and aspect; ans2label by the port's make_labels)
            is loaded by load_examples, make_backend and ViltVQAPipeline
            (B=64, cached u8 pixels normalised on the card, canvas 384x640,
            S=281) into full-width ViLT-B/32 DAT, bf16, "layer", the fused
            step, graphs, the pinned prefetch.  Run A: 3 rounds with a
            checkpoint each; run B: the same with a SIGTERM raised at round
            1's first step, then a fresh trainer resumes at round 2; A and B
            bitwise equal (server, personal stores, last evaluation).
            ViltVqaPredictor.from_checkpoint on "block" with the fused
            adapter (#1, #2) answers each client's eval questions bitwise
            like a predictor built from the trainer's parameters, and within
            5% of the largest probability of the plain route; one ALBEF
            client fed by AlbefVQAPipeline trains a round on "flash"
            (dropout live, #7-#9) with a checkpoint, and
            AlbefVqaPredictor.from_checkpoint ranks with the recipe's answer
            list, bitwise a predictor from the trainer's parameters.  Prints
            each round's time from disk, the idle share of a replayed round,
            host ms per batch with the cache cold and warm, one checkpoint's
            save and restore, and #1/#4's launches per step from the device.
13. cli — the launch surface on phase 12's dataset: ``python -m
            feddat_tpu_torch.cli`` in processes of its own with the flags of
            scripts/train_vilt_tpu_tuned.sh and train_albef_tpu_tuned.sh
            (read from the scripts) and tests/fixtures/vocab30k.txt.  Two
            clients of ``--engine spmd`` on one card exit non-zero with
            JAX's ``need 2 devices, have 1`` before any model is built;
            ``cli.main`` trains ViLT LoRA in float32 on ``"fused"`` (one
            client, one round: return 0, the task's score, #5/#6 launched
            and nothing else); the
            ViLT script's flags less ``--engine spmd`` (the sequential
            engine), one client, 2 rounds with --checkpoint_dir and
            --profile_dir: exit 0, the three DAT scores, step and round
            records, #1 and #4 24 times per step in round 0's trace (read
            back from its file, by kernel name); the script as it is,
            ``--engine spmd`` (a world of one over NCCL), on the same client
            for 1 round unprofiled: exit 0, the ``(x1 clients stacked)``
            budget line, JAX's checkpoint layout (the stacked client bank)
            and a round 0 bitwise the profiled sequential launch's (the
            CLI's resume is held on the CPU, tests/test_torch_cli.py, and
            the engine's on the card by phase 12).  Host ms per
            batch through the CLI's own client builder with the u8 cache
            finalized by the native host core against numpy's finalize,
            bitwise equal;
            ViltVqaPredictor.from_checkpoint on the CLI's meta.json on
            "block" with the fused adapter (#1, #2) within 5% of the largest
            probability of the plain route.  ALBEF, the tuned flags at
            B=48 x 4, one client, one round, --debug 2: exit 0, #1 and #4 24
            times per step in its trace, meta.json's answer list, and
            AlbefVqaPredictor.from_checkpoint ranking on "flash" (#7).
            Prints each launch's seconds to its first step and to its exit,
            the round walls and samples/s of the metrics log.
14. modes — the sequential engine's other training modes, full width.
            ALBEF at B=16 x 4 (MODES_AB).  (a) albef_distill in adapter
            mode, bf16, "flash", the plain step with dropout 0.1 live:
            #7/#8/#9 launches 24/11/11
            (the ViT sites of the twin's forward and the model's); two steps
            replayed bitwise two eager ones (losses, trained tensors, the
            twin); the twin's EMA bitwise a host fp32 recompute of
            m*0.995 + p*0.005; the twin handed back as the program's own
            tensors and one capture while alpha ramps 0, 0.1, 0.2, 0.3;
            launches from the device's kernel names and host launches per
            replay, with distillation (graph against eager) and without
            (one profiled replay); with dropout off the gradients by the
            2x-bf16 rule
            (#7/#8/#9 84/39/39); a FederatedTrainer round of 2 clients x 2
            steps with the distill hooks, one capture.  (b) ALBEF prompt
            tuning, dropout off: one step with the fusion cross-attention
            at 577 + 5 keys on #7-#9, its gradients by the 2x-bf16 rule, a
            round with a checkpoint, and
            AlbefVqaPredictor.from_checkpoint ranking on "flash" bitwise a
            predictor from the trainer's parameters.  (c) the joint DAT step
            on ViLT-B/32 at B=64, S=185, attn_impl='layer': #1 12, #3 11, no
            #4 (the weighted rows take the "block" way), its four gradient
            sets against the standard step's plain fp32 path by the 2x-bf16
            rule, launches from the device, samples/s against the standard
            "block" step.  (d) ViLT adapter, none and freeze_encoder on
            "fused": one step each, #5/#6 12/11, 12/0, 12/0 (also from the
            device's kernel names in one profiled replay), the 2x-bf16 rule.  (e) ``python -m feddat_tpu_torch.cli --encoder_name
            albef_distill`` with scripts/train_albef.sh's flags and
            ``--optimizer_mode adapter --dtype bfloat16 --attn_impl flash``
            on phase 12's dataset, 1 client x 3 steps, profiled (#7/#8/#9
            24/11/11 per step from the trace), then from_checkpoint on
            "flash" (#7).
15. spmd — the SPMD engine (``federated/spmd.py``) in a world of one over
            NCCL, against the sequential engine on the same client, weights,
            seed and steps: (a) full-width ViLT-B/32 DAT, bf16, the fused
            step on "layer", B=64, S=185, a round of 2 steps and
            evaluate_dat; (b) full-width ALBEF DAT on "flash", dropout live,
            B=48 x 4, 2 fused steps and the rank-answer evaluation.  The
            gradient mean (inside each step's captured graph), FedAvg and
            the evaluation gather are NCCL all-reduces over groups of one,
            so server parameters, personal store and scores must be bitwise
            the sequential engine's, and every kernel's launches equal
            (#1, #4 and #2; #7-#9), those of the path above zero.  The SPMD
            round must capture its step with the step's all-reduce called
            inside the capture and replay it; one profiled step must be one
            graph launch that calls no all-reduce from the host (NCCL's
            all-reduce over a group of one launches no kernel; the NCCL
            kernels inside the replay over 4 cards are held by
            ``scripts/torch_spmd_cards.py``).
16. classify — the ViLT family's other tasks (ROADMAP item 10), written
            from --seed into a temporary directory in their reference
            layouts (NLVR2 image pairs, SNLI-VE over Flickr30K ids, VCR's
            four choices on drawn images, VQAv2 over COCO ids) and built by
            the CLI's own ``build_clients``/``build_model``/``init_params``/
            ``sequential_trainer`` with the tuned ViLT script's flags on the
            sequential engine: full-width ViLT-B/32 DAT, bf16, "layer",
            canvas 384x640 (S=281).  (a) NLVR2 (32 pairs, two encoder
            passes per example, the second with modality type 2), SNLI-VE
            (B=64) and VCR (B=64 x 4 choices) on the standard DAT step: one
            step's gradient sets and losses per task, kernel path against
            the plain path by the 2x-bf16 rule (VCR on 16 of its 64
            examples); one round of 2 steps per client, FedAvg and
            evaluate_dat, each client's #1/#4 launches per step (3 and 2 per
            layer per encoder pass, no #3) and peak memory.  (b) ViLT-BERT
            on the 5% low-shot VQAv2 client (u8 pixels normalised on the
            card): one round of 2 fused steps (#1/#4 24 per step; its text
            BERT deterministic there, as in JAX) and evaluate_dat, then 2
            standard DAT steps with the BERT's dropout 0.1 live (equal
            losses from one seed, others from another); text_bert bitwise
            unchanged by both.
17. study — the accuracy study (``feddat_tpu_torch/study.py``) as
            ``scripts/torch_accuracy_study.py`` runs it: ``run_study`` on the
            card at full width, the ViLT family (ViLT-B/32, bf16, canvas
            192x192, S=77, "block" with block_save_nox remat and fused LN),
            mode dat, seed --seed, 4 synthetic clients x 2 rounds of 8
            standard DAT steps at B=32, FedAvg, one evaluation in the three
            DAT modes, through the engine's replayed graphs.  Checks: each
            round's #1/#3 launches 36/22 per step and nothing else, its
            replays (no capture in round 1), every logged loss finite,
            JAX's history schema (three scores per client; the table's
            client_0..3 and average), and the average ensemble score above
            chance (100/11: 11 answers are reachable).  Prints each client's
            three scores, the round walls and the phase's seconds.
18. tp    — tensor parallelism (``parallel/tp.py``): two ranks share the one
            card over gloo (NCCL refuses two ranks on one device; gloo carries
            all-reduces of CUDA tensors through the host), each in a process
            of its own, at (data=1, model=2): full-width ViLT-B/32 DAT, bf16,
            attn_impl='auto' (JAX's --tp guard forces it), B=64, S=185, a
            16-label head (a 3129-label one scores 0 after two steps), one
            FederatedTrainer round of 2 fused steps and evaluate_dat, eagerly
            (a gloo collective cannot be captured).  Against the world-of-one
            engine on the same weights, client and seed in bf16, with the
            same run in fp32 as the exact function: the communicated
            partition's update (adapter_1 after the round less its initial
            value) and the three scores by the 2x-bf16 rule (scores with a
            floor of one example's score).  Each rank holds half of every
            sharded kernel (bytes printed against tp=1), and #1-#9 launch no
            time on the path (no kernel partitions over the model axis).
19. fp32  — every kernel route in float32 (#1-#9 take fp32, as the TPU
            kernels run in the model's dtype), eagerly.  (a) Each
            kernel alone in fp32 at full width, #1, #3 and #4 (one adapter)
            at the training shape (B=64, S=185) and #2 at the serving shape
            (B=16, S=281): on every output the kernel's largest error against
            the plain version evaluated in float64 (its fp32 casts taken to
            float64) at most 8x the plain fp32 version's (TF32 off) or 2^-20
            of the output's largest magnitude; the same check on the kernel
            run with its operands rounded to bf16 once must fail (#4's
            references take the kernel's ReLU gate, so a gate flip within
            rounding noise of 0 is not read as an error); #5/#6 at B=64,
            S=185 with a padding bias and #7-#9 at ALBEF's ViT site (B=16,
            S=577, no bias), with key-row biases (text self, fusion cross)
            and with [query][key] tiles (the decoder's causal + padding, the
            rerank decoder's packed block-diagonal bias, a per-head tile over
            several ring steps), forward and backward, by the same
            criterion.  The patch
            embedding (cuDNN) against float64 with cuDNN's TF32 at
            PyTorch's default.  (b) #4 at bottlenecks 24, 96 and 192 in bf16
            at B=64, S=185 under its bf16 limits.  (c) The slice's path in
            fp32 at full width (ViLT-B/32 DAT): one fused DAT step on
            "layer" (#1/#4 24 launches each) and one standard DAT step on
            "block" with the fused ensemble (#1 36, #2 24, #3 22), each
            against the plain fp32 path ("auto") on the same weights and
            batch (each gradient set's relative Frobenius error at most
            1e-4, losses within 1e-5 relative); one FederatedTrainer round
            of 2 clients x 2 fused steps on "layer" with FedAvg and
            evaluate_dat; one ViltVqaPredictor forward at B=16, S=281 on
            "block" with fused LN (#1/#2 12 each), its top-1 answers against
            the plain fp32 path's.  Then "fused" and "flash": one LoRA step
            of ViLT-B/32 on "fused" (#5/#6 12 each) against the plain fp32
            path and one LoRA round of 2 clients (FedAvg moves every LoRA
            tensor); one ALBEF fused DAT step on "flash", dropout off, B=16
            x 4 answers (#7 84, #8/#9 78 each) against the plain fp32 path;
            AlbefVqaPredictor.predict at B=16 (#7 54), its top-1 answers
            equal the plain fp32 path's.  (d) Each fp32 kernel's device
            time, its bound (operations at the TF32 rate or bytes), its
            plain version and the library call or chain in fp32 with TF32
            off; #8/#9's one-stage fp32 tile instances beside bf16's; #4 in
            bf16 at bottlenecks 96 and 192.  Prints the phase's seconds.
20. shapes — every head dim and width JAX's kernels take, eagerly.  (a) Each
            kernel against its plain version at its existing limits, in bf16
            and fp32 (the float64 criterion of phase 19): #5-#9 at head dims
            8, 12, 16, 32, 80, 128 and 256 (S on both sides of the 64-row
            tile edges, a padding row and a per-head bias tile); #1/#3/#4 at
            (Dm, heads, F) = (32, 4, 64), (48, 4, 96) and (192, 3, 768); #2
            at widths 32, 48, 100 and 192.  (b) Two full-width layer
            geometries, each a 2-layer ViLT DAT model from create_model with
            ViltModelConfig at that width, random weights from --seed, bf16,
            S=185, the steps at B=64 and the serving forward at B=16:
            ViT-H/14's layer (Dm 1280, 16 heads of 80, F 5120,
            R=80) and DeiT-Ti's (Dm 192, 3 heads of 64, F 768, R=12).  On
            each: the fused DAT step on "layer" (#1, #4), the standard step
            on "block" (#1, #3), the serving forward on "block" with the
            fused ensemble (#1, #2), a LoRA step on "fused" (#5, #6) and one
            on "flash" (#7-#9), each held against the plain path as phases
            train, peft and serve hold theirs, with its launch counts.
            (c) The JAX CLI's --smoke widths on the kernel routes: ViLT at
            Dm 32, 4 heads, F 64, R 8 through the same five paths, and ALBEF
            (ViT and BERT at width 32, 4 heads) with its fused DAT step and
            rank_answer on "flash".  One line per part.

Prints the card's ``nvidia-smi`` name and power limit, one JSON line with every
kernel's numbers, and as the last line ``{"ok": true, "device": {...}}``.
Exits non-zero, without that line, if there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import argparse
import atexit
import bisect
import contextlib
import gc
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

REPO = Path(__file__).resolve().parent
# H100 SXM published peaks (dense): bf16 tensor cores, fp32 CUDA cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# Serving shape: B=16 requests, S = 40 text + 12*20 patches + CLS = 281 tokens.
B, TEXT_LEN, CANVAS = 16, 40, (384, 640)
S = TEXT_LEN + (CANVAS[0] // 32) * (CANVAS[1] // 32) + 1
DM, HEADS, R = 768, 12, 48
FF = 3072  # the layer's FFN width (phase 20 rebinds DM, HEADS and FF: ``widths``)
# Alternating kernel/plain samples of the time phase's rates (train, LoRA,
# ALBEF step and rank_answer; twice as many serving forwards): 3 (6 and 4
# before phase 20 came), the seconds phase 20 needs; no check reads them,
# and item 7's bench takes the rates over.
TIME_PAIRS = 3
# Training shape: B=64, S = 40 text + 12*12 patches of a 384x384 canvas + CLS = 185.
TB, TCANVAS = 64, (384, 384)
TS = TEXT_LEN + (TCANVAS[0] // 32) * (TCANVAS[1] // 32) + 1
# The accuracy study's ViLT step (phase 17): B=32, S = 40 text + 6*6 patches
# of a 192x192 canvas + CLS = 77.
STUDY_SHAPE = (32, TEXT_LEN + (192 // 32) ** 2 + 1)
NUM_LABELS = 3129  # VQAv2 answer vocabulary (feddat_tpu/configs/tasks.py:96)
# TF32 tensor-core peak (dense), the rate charged for #7's P.v: P is kept at
# fp32 precision as two bf16 products (hi + lo), the work of one TF32 product.
PEAK_TF32_FLOPS = 495e12
# ALBEF serving (slice 4): B=16 requests, 384x384 images -> ViT-B/16 S = 24*24 + 1
# = 577; questions of 25 tokens, answers of 10; k=64 candidates of a 100-answer
# bank (cli.py:218), the rerank decode packed 8 per row (eval_pack_group).
AB, ARES, LQ, LA, ALBEF_K, PACK = 16, 384, 25, 10, 64, 8
VIT_S = (ARES // 16) ** 2 + 1
# A stand-in for the first 100 entries of a VQA ans2label (no dataset in the
# repo): common VQA answers, multi-word ones sharing first tokens with others.
ALBEF_ANSWERS = [
    "yes", "no", "2", "1", "white", "3", "red", "blue", "4", "green", "black", "yellow",
    "brown", "0", "5", "gray", "6", "orange", "pink", "tennis", "frisbee", "baseball",
    "skateboarding", "7", "surfing", "wood", "kitchen", "8", "dog", "cat", "skiing", "10",
    "left", "right", "grass", "water", "giraffe", "pizza", "purple", "silver", "man", "woman",
    "snow", "bathroom", "nothing", "horse", "elephant", "zebra", "train", "bus", "cow", "sheep",
    "beach", "street", "table", "sitting", "standing", "walking", "eating", "playing",
    "umbrella", "kite", "banana", "apple", "sandwich", "cake", "phone", "laptop", "clock", "bed",
    "chair", "couch", "night", "day", "sunny", "cloudy", "summer", "winter", "male", "female",
    "tennis racket", "baseball bat", "baseball glove", "fire hydrant", "stop sign", "hot dog",
    "teddy bear", "cell phone", "red and white", "black and white", "blue and white",
    "surf board", "ski poles", "dog food", "2 people", "1 person", "wii controller",
    "bathroom sink", "cutting board", "parking meter",
]


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def bf16_ulp(v: float) -> float:
    """Spacing of bf16 numbers at magnitude ``v`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(v, 1e-30))) - 7)


DEVICE_MS_MARK = "chip_smoke.device_ms"
# device_ms's own record: profiles taken, profiles taken again, and for each
# profile its closing marker kernel's device start less the host's call to
# launch it (us): launch latency plus the offset between the profiler's clocks
DEVICE_MS_STATS = {"profiles": 0, "again": 0, "lag_us": []}


# Calls that open every profile and are not counted: late in a run the
# profiler drops the device events of a profile's first calls, markers
# included (from one call up to five calls of the 0.4 ms library chain at
# B=48, S=577, five profiles in a row); a profile taken again doubles them.
PROFILE_LEAD = 4


class ProfEvent:
    """One event of a finished profile, with the fields of ``prof.events()``'s
    FunctionEvent that this script reads."""
    __slots__ = ("name", "device_type", "time_range", "is_user_annotation", "self_cpu_time_total",
                 "thread", "is_async")


def profile_events(torch, prof):
    """The events of a finished torch.profiler profile as ``prof.events()``
    gives them (the same names, times from the trace's start, and events left
    out, the dispatcher's nested records of one op included), read from its
    kineto results without building a FunctionEvent per event in Python:
    ``prof.events()`` took 199 s of a 975 s run of this script on an H100
    (``scripts/chip_smoke_timings.py``), 43-68 s for one profile of eager
    ALBEF steps.  ``self_cpu_time_total`` is the event's own duration (read
    only for kernel launch calls, which have no children)."""
    from torch.autograd.profiler_util import Interval, _filter_name

    results = prof.profiler.kineto_results
    start = results.trace_start_ns()
    cpu = torch.autograd.DeviceType.CPU
    names, out = {}, []
    for k in results.events():
        raw = k.name()
        if _filter_name(raw) or getattr(k, "is_hidden_event", lambda: False)():
            continue
        e = ProfEvent()
        name = names.get(raw)
        if name is None:
            name = names[raw] = torch._C._demangle(raw) if len(raw) > 1 else raw
        e.name = name
        e.device_type = k.device_type()
        e.time_range = Interval((k.start_ns() - start) / 1000, (k.end_ns() - start) / 1000)
        e.is_user_annotation = k.is_user_annotation()
        e.self_cpu_time_total = e.time_range.elapsed_us()
        e.thread = k.start_thread_id()
        e.is_async = k.is_async() or k.start_thread_id() != k.end_thread_id()
        out.append(e)
    # EventList._build_tree's nesting: each thread's synchronous CPU events by
    # their intervals; then _remove_dup_nodes drops an event whose parent has
    # its name and no other child, until none is left
    out.sort(key=lambda e: (e.time_range.start, -e.time_range.end))
    parent, children, stacks = {}, {}, {}
    for i, e in enumerate(out):
        if e.device_type != cpu or e.is_async:
            continue
        stack = stacks.setdefault(e.thread, [])
        while stack:
            p = out[stack[-1]].time_range
            if e.time_range.start >= p.end or e.time_range.end > p.end:
                stack.pop()
            else:
                parent[i] = stack[-1]
                children.setdefault(stack[-1], []).append(i)
                break
        stack.append(i)
    gone = set()
    while True:
        drop = set()
        for i in range(len(out)):
            if i in gone:
                continue
            p = parent.get(i)
            if p is not None and out[p].name == out[i].name and len(children.get(p, ())) == 1:
                children[p] = children.get(i, [])
                for c in children[p]:
                    parent[c] = p
                drop.add(i)
        if not drop:
            break
        gone |= drop
    return [e for i, e in enumerate(out) if i not in gone]


def profile_calls(torch, fn, calls: int, lead: int = PROFILE_LEAD):
    """Profile ``lead + calls`` calls of ``fn`` -> (the device events
    of each of the last ``calls`` calls as [(start, us, name)], or None when
    fewer markers came back; the closing marker's device start less the
    host's call to launch it, us, or None).

    Before each call, and after the last, the host launches a marker
    (``torch.cuda._sleep``'s spin kernel, which no timed function launches);
    after each call it synchronizes.  The device events between one marker and
    the next, in the device clock's order, are that call's, whatever the
    host's clock says: on the H100 the two have run milliseconds apart."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(lead + calls + 1):
            with record_function(DEVICE_MS_MARK):
                torch.cuda._sleep(1000)
            if i < lead + calls:
                fn()
            torch.cuda.synchronize()
    events = profile_events(torch, prof)
    marks = sorted(e.time_range.start for e in events
                   if e.name == DEVICE_MS_MARK and e.device_type != cuda)
    device = sorted((e.time_range.start, e.time_range.elapsed_us(), e.name) for e in events
                    if e.device_type == cuda and not getattr(e, "is_user_annotation", False)
                    and e.name != DEVICE_MS_MARK)
    at = [i for i, (_, _, name) in enumerate(device) if "spin_kernel" in name][-(calls + 1):]
    if len(at) < calls + 1:
        print(f"profile_calls: a profile gave {len(device)} device events with {len(at)} of the last "
              f"{calls + 1} markers")
        return None, None
    lag = device[at[-1]][0] - marks[-1] if marks else None
    return [device[a + 1:b] for a, b in zip(at, at[1:])], lag


def device_ms(torch, fn, iters: int = 10, warmup: int = 3) -> float:
    """Median device milliseconds of one call of ``fn`` over ``iters`` calls
    after ``warmup``: the sum of the durations of the CUDA kernels (and copies)
    that torch.profiler records for the call (:func:`profile_calls`).  The
    host's dispatch rate does not enter, as it does in :func:`cuda_ms` when
    the host is the slower side.  A profile in which one of the calls got no
    device time is taken again, 5 times at most: late in a run the profiler
    has lost most events of three profiles in a row on an H100 (0, 7 and 15
    device events where a dozen calls make hundreds), each time with twice
    the uncounted lead calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    tries = 5
    for t in range(tries):
        DEVICE_MS_STATS["profiles"] += 1
        per_call, lag = profile_calls(torch, fn, iters, PROFILE_LEAD << t)
        totals = [sum(us for _, us, _ in call) for call in per_call or []]
        if len(totals) == iters and min(totals) > 0:
            if lag is not None:
                DEVICE_MS_STATS["lag_us"].append(lag)
            return statistics.median(totals) / 1e3
        DEVICE_MS_STATS["again"] += 1
        print(f"device_ms: calls without device time {totals.count(0.0)} of {len(totals)}")
    check(False, f"torch.profiler recorded no device time for a timed call in {tries} profiles")


def cuda_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean wall milliseconds per call by CUDA events over back-to-back calls
    (warm caches): the "wall per call" of the readable lines."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def launch_breakdown(torch, fn, label, calls: int = 5):
    """Device milliseconds of each launch of one call of ``fn``, in launch
    order, median over ``calls`` calls (:func:`profile_calls`) ->
    [(kernel name, ms)].  A profile that lost calls' device events is taken
    again, 3 times at most, as in :func:`device_ms`."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for t in range(3):
        per_call, _ = profile_calls(torch, fn, calls, PROFILE_LEAD << t)
        if per_call is not None:
            break
        DEVICE_MS_STATS["again"] += 1
    counts = {len(c) for c in per_call or []}
    check(per_call is not None and len(counts) == 1 and 0 not in counts,
          f"breakdown {label}: calls with {sorted(counts)} launches")
    rows = [(per_call[0][j][2], statistics.median(c[j][1] for c in per_call) / 1e3)
            for j in range(counts.pop())]
    total = sum(ms for _, ms in rows)
    print(f"breakdown {label}: {len(rows)} launches, {total:.4f} ms device (median of {calls} calls "
          f"per launch)")
    for name, ms in rows:
        print(f"  {ms:8.4f} ms {100 * ms / total:5.1f}%  {name[:100]}")
    return rows


def time_row(torch, label, kernel, plain, library, bound, library_name):
    """One kernel's row of the JSON line -> (ms, plain_ms, library_ms, bound_ms,
    bound_by, operations): the kernel, its plain version and one PyTorch call
    (chain) for the same function, each by :func:`device_ms`, beside the
    bound.  The readable line adds the kernel's and the library's wall per
    call by CUDA events."""
    bound_ms, bound_by, ops = bound
    k_ms, l_ms = device_ms(torch, kernel), device_ms(torch, library)
    p_ms = device_ms(torch, plain, iters=3, warmup=1)
    k_wall, l_wall = cuda_ms(torch, kernel, 20), cuda_ms(torch, library, 20)
    print(f"time {label}: kernel {k_ms:.4f} ms device ({ops / k_ms / 1e9:.1f} TFLOP/s; wall per call "
          f"{k_wall:.4f}), bound {bound_ms:.4f} ms by {bound_by} ({100 * bound_ms / k_ms:.1f}% of bound), "
          f"plain {p_ms:.4f} ms device, library ({library_name}) {l_ms:.4f} ms device (wall per call "
          f"{l_wall:.4f}); kernel / library {k_ms / l_ms:.2f}x")
    return k_ms, p_ms, l_ms, bound_ms, bound_by, ops


# ----------------------------------------------------------------- inputs
def attn_inputs(torch, b, s, fuse_ln, seed, masked=True, bias=None, dtype=None):
    """Attention-block inputs on the card: bf16 (or ``dtype``) activations and
    weights, fp32 biases/LN, and a padding bias like the model's (text
    padding + masked image patches at -10000; none when not ``masked``, as
    ALBEF's ViT has none).  The biases are drawn at the scale of the projections they are
    added to, so a dropped or misplaced bias moves the outputs far past the
    tolerances (bk only through lse: the softmax is shift-invariant per
    query)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g, device="cuda") * std).to(dtype)

    dt = dtype or torch.bfloat16
    x = randn(b, s, DM, dtype=dt)
    ws = [randn(DM, DM, std=0.04, dtype=dt) for _ in range(4)]
    bqkv, bo = randn(3, DM, std=1.0), randn(1, DM, std=1.0)
    gb = torch.stack([1.0 + randn(DM, std=0.1), randn(DM, std=0.1)]) if fuse_ln else None
    valid = torch.randint(max(1, s // 3), s + 1, (b, 1), generator=g, device="cuda")
    keys = torch.arange(s, device="cuda")[None, :]
    if bias is None:
        bias = ((keys >= valid).float() * -10000.0)[:, None, None, :] if masked else None
    return (x, *ws, bqkv, bo, gb, bias, HEADS, 64 ** -0.5, 1e-12 if fuse_ln else None)


def adapter_inputs(torch, n, seed, r=R, d=DM, dtype=None):
    """Adapter inputs on the card at width ``d``, all bf16 (or ``dtype``); the
    biases are drawn at the scale of the products they are added to (down
    ~1.4 at d = 768, up ~0.3 at r = 48), so a dropped bias shows."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def p(*shape, std):
        return (torch.randn(*shape, generator=g, device="cuda") * std).to(dtype or torch.bfloat16)

    h = p(n, d, std=1.0)
    pa = (p(d, r, std=0.05), p(r, std=1.0), p(r, d, std=0.05), p(d, std=0.5))
    pb = (p(d, r, std=0.05), p(r, std=1.0), p(r, d, std=0.05), p(d, std=0.5))
    return h, pa, pb, 0.5


def adapter_probe_inputs(torch, n, r=R, b_units=(5, 6)):
    """A constructed case whose ReLU outputs carry bits below a bf16 hi + lo
    pair.  Every row of h is 1 at columns 0, D/4 and D/2 (three K slices of
    the kernel's cluster), so a's bottleneck units 0 and 1 are x0 = 1 + 2^-9
    + 2^-18 and x1 = 1 + 2^-9, b's units ``b_units`` (5 and 6; past 128 at a
    wider ``r``, in the kernel's second chunk of the bottleneck) are 1 + 2^-9
    + 3 2^-19 and 1 + 2^-9, all exact in fp32.  Wu rows +1 and -1 leave
    a = 2^-18 and b = 3 2^-19 in every column, so the mix at w = 0.5 is
    5 2^-20 exactly.  x = hi + mid + lo carries x0 exactly; hi + lo with
    lo = bf16(x - hi) gives x0 = x1 and a mix of 0."""
    bf, k1, k2 = torch.bfloat16, DM // 4, DM // 2
    h = torch.zeros(n, DM, dtype=bf, device="cuda")
    h[:, [0, k1, k2]] = 1.0
    params = []
    for (u0, u1), low in (((0, 1), 2.0 ** -18), (b_units, 3 * 2.0 ** -19)):
        wd = torch.zeros(DM, r, dtype=bf, device="cuda")
        wd[0, [u0, u1]] = 1.0
        wd[k1, [u0, u1]] = 2.0 ** -9
        wd[k2, u0] = low
        wu = torch.zeros(r, DM, dtype=bf, device="cuda")
        wu[u0], wu[u1] = 1.0, -1.0
        params.append((wd, torch.zeros(r, dtype=bf, device="cuda"), wu,
                       torch.zeros(DM, dtype=bf, device="cuda")))
    return h, params[0], params[1], 0.5, 5 * 2.0 ** -20


# ------------------------------------------------------------------ bounds
def tensor_peak(f32):
    """The card's fastest rate for products of the element type's operands:
    bf16 on the tensor cores, or 32-bit operands at the TF32 rate (no faster
    way to multiply them exists on the card)."""
    return PEAK_TF32_FLOPS if f32 else PEAK_BF16_FLOPS


def attn_block_bound(b, s, fuse_ln, masked=True, f32=False):
    """Least time (ms) for one attention-block call and what bounds it.

    The projections, q.k^T and P.v take bf16 operands (tensor cores; fp32
    ones at the TF32 rate with ``f32``); the softmax and the LayerNorm are
    fp32 work on the CUDA cores.  The two pipes run at once, so the
    operations' floor is the larger of their two times."""
    m, d, es = b * s, DM // HEADS, 4 if f32 else 2
    bf16_ops = 2 * m * DM * DM * 4 + 2 * 2 * b * HEADS * s * s * d  # 4 projections + QK^T + PV
    fp32_ops = b * HEADS * s * s * 6 + (m * DM * 8 if fuse_ln else 0)  # softmax (+ LN)
    t_ops = max(bf16_ops / tensor_peak(f32), fp32_ops / PEAK_FP32_FLOPS)
    nbytes = (3 * m * DM * es + 4 * DM * DM * es + 4 * DM * 4 + (2 * DM * 4 if fuse_ln else 0)
              + (b * s * 4 if masked else 0) + b * HEADS * s * 4)  # x, out, ctx; weights; biases; mask; lse
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), bf16_ops


def adapter_bound(n, r=R, d=DM, f32=False):
    """Least time (ms) for one ensemble-adapter call, what bounds it, and its
    operations.

    The down projections multiply bf16 h by bf16 Wd: the products are exact
    in fp32, so tensor cores with fp32 sums do that work at the bf16 rate.
    The up projections multiply the fp32 ReLU output x by bf16 Wu; x splits
    exactly enough into three bf16 parts (hi + mid + lo, residual below
    2^-24 |x|), so they are three bf16 products with fp32 sums, also at the
    bf16 rate.  The bias, ReLU, split and mix are fp32 work on the CUDA
    cores; the pipes overlap, so the floor is the larger time.  Bytes: h in,
    the mix out, both adapters' weights and biases once each.  With ``f32``
    every operand is fp32: the two projections at the TF32 rate."""
    mm = n * 2 * 2 * d * r  # one projection of both adapters
    bf16_ops = 2 * mm if f32 else mm + 3 * mm
    fp32_ops = n * (2 * 2 * r + 4 * 2 * r + 4 * d)  # bias + relu, split, bias + mix
    es = 4 if f32 else 2
    nbytes = 2 * n * d * es + 2 * (2 * d * r + r + d) * es
    t_ops = max(bf16_ops / tensor_peak(f32), fp32_ops / PEAK_FP32_FLOPS)
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), bf16_ops


def attn_bwd_ops(b, s):
    """bf16 tensor-core operations of the attention backward (the part #3 and
    #4 share): dctx = g.Wo, the q/k/v recompute and dx = dq.Wq + dk.Wk + dv.Wv
    (14 M Dm^2), plus the five per-head products the TPU kernel does (s, dP,
    dv, dq, dk: 10 S^2 d per head; the CUDA kernel recomputes s and dP once
    more, which the bound does not charge)."""
    m, d = b * s, DM // HEADS
    return 14 * m * DM * DM + 10 * b * HEADS * s * s * d


def attn_bwd_bound(b, s, fuse_ln, masked=True, f32=False):
    """Least time (ms) for one #3 call and what bounds it: the bf16 products
    above on the tensor cores (fp32 ones at the TF32 rate with ``f32``)
    beside the fp32 softmax recompute and LN forward/backward on the CUDA
    cores (the pipes overlap); bytes: x, ctx, g and dx once each, the four
    weights, biases, mask, lse."""
    m, es = b * s, 4 if f32 else 2
    bf16_ops = attn_bwd_ops(b, s)
    fp32_ops = b * HEADS * s * s * 8 + (m * DM * 16 if fuse_ln else 0)
    t_ops = max(bf16_ops / tensor_peak(f32), fp32_ops / PEAK_FP32_FLOPS)
    nbytes = (4 * m * DM * es + 4 * DM * DM * es + 3 * DM * 4 + 2 * DM * 4 + (b * s * 4 if masked else 0)
              + b * HEADS * s * 4)
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), bf16_ops


def layer_bwd_bound(b, s, use_b, ffn=None, masked=True, r=R, f32=False):
    """Least time (ms) for one #4 call and what bounds it.  bf16 operands
    (tensor cores): the FFN recompute and its backward (4 products of M Dm F),
    the attention backward above, and the adapter products — all of bf16
    values with fp32 sums, so tensor-core work too (down, g_relu, g_o for each
    member, dWu and dWd: (6 if ensemble else 3) + 2 products of M Dm r).  fp32
    on the CUDA cores, overlapping: GELU and its derivative over M F, the
    softmax recompute, two LayerNorms forward and backward.  Bytes: x, aout,
    ctx, g and dx once each, every weight, lse.  Adapters of bottleneck
    ``r``; with ``f32`` every operand is fp32 and the products run at the
    TF32 rate.  FFN width ``ffn``, default :data:`FF`."""
    m, es, ffn = b * s, 4 if f32 else 2, ffn or FF
    adapter = ((6 if use_b else 3) + 2) * 2 * m * DM * r
    bf16_ops = 4 * 2 * m * DM * ffn + attn_bwd_ops(b, s) + adapter
    fp32_ops = m * ffn * 40 + b * HEADS * s * s * 8 + m * DM * 32
    t_ops = max(bf16_ops / tensor_peak(f32), fp32_ops / PEAK_FP32_FLOPS)
    nbytes = (5 * m * DM * es + (4 * DM * DM + 2 * DM * ffn) * es + (3 * DM + ffn + 6 * DM) * 4
              + 2 * (2 * DM * r * es + (r + DM) * 4) + (b * s * 4 if masked else 0) + b * HEADS * s * 4)
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), bf16_ops


def fused_attention_bound(b, s, backward, f32=False):
    """Least time (ms) for one #5 (forward) or #6 (backward) call and what
    bounds it.  bf16 operands (tensor cores; fp32 ones at the TF32 rate with
    ``f32``): q.k^T and P.v (4 B H S^2 d), or the five per-head products of
    the TPU kernel (s, dP, dv, dq, dk: 10 B H S^2 d); beside them on the CUDA
    cores the fp32 softmax or its recompute (6 or 8 operations per logit); the
    pipes overlap.  Bytes: q, k, v, o (and dO in, dq, dk, dv out) once each,
    the bias row and lse."""
    d = DM // HEADS
    per_head = b * HEADS * s * s * d
    bf16_ops = (10 if backward else 4) * per_head
    fp32_ops = b * HEADS * s * s * (8 if backward else 6)
    t_ops = max(bf16_ops / tensor_peak(f32), fp32_ops / PEAK_FP32_FLOPS)
    nbytes = (8 if backward else 4) * b * HEADS * s * d * (4 if f32 else 2) + b * s * 4 + b * HEADS * s * 4
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), bf16_ops


def flash_bound(b, sq, skv, bias_numel, f32=False):
    """Least time (ms) for one #7 call and what bounds it.  Tensor cores: q.k^T
    on bf16 operands at the bf16 peak, P.v with P at fp32 precision at the TF32
    peak (with ``f32`` both at the TF32 peak); beside them on the CUDA cores
    the online softmax (~6 fp32 operations per logit); the pipes overlap.
    Bytes: q, k, v and o in bf16 (fp32 with ``f32``), lse in fp32 and the
    compact fp32 bias once each."""
    prod = 2 * b * HEADS * sq * skv * (DM // HEADS)
    t_tensor = prod / tensor_peak(f32) + prod / PEAK_TF32_FLOPS
    t_ops = max(t_tensor, 6 * b * HEADS * sq * skv / PEAK_FP32_FLOPS)
    nbytes = 2 * (4 if f32 else 2) * b * HEADS * (sq + skv) * (DM // HEADS) + b * HEADS * sq * 4 + bias_numel * 4
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), 2 * prod


# ------------------------------------------------------------------ phases
def phase_build():
    from feddat_tpu_torch.ops import _build

    t0 = time.perf_counter()
    reports = _build.build()
    secs = time.perf_counter() - t0
    print(f"build: {len(reports)} kernel sources compiled in {secs:.1f} s ({', '.join(reports)})")
    for name, log in reports.items():
        for line in _build.ptxas_summary(log):
            print(f"  ptxas {name}: {line}")


def mask_tag(masked, bias):
    """How a parity line names its key mask: a random padding bias (no
    tag), none, or a given one (the from-disk fixture's canvases)."""
    return " fixture mask" if bias is not None else ("" if masked else " unmasked")


# #1 against its plain version, out and ctx also elementwise in bf16 ulps of
# each element's own magnitude (own_ulps), beside the max-abs check below.
# Both sides round q/k/v, P, ctx and out to bf16 after fp32 sums taken in
# another order.  Limit set from this phase's readings on the card (PERF.md
# §6, #1) at the serving and training shapes, the small ones and M = 127, 128,
# 129 and 257, with and without LN1: sound <= 2 own ulps (ctx at B=64, S=185),
# planted (one row off by the rms, read in every case) >= 129: limit 8.
ATTN_OWN_ULPS = 8


def attn_parity(torch, b, s, fuse_ln, seed, masked=True, bias=None):
    from feddat_tpu_torch.ops import attn_block as ab

    args = attn_inputs(torch, b, s, fuse_ln, seed, masked, bias)
    mtag = mask_tag(masked, bias)
    with torch.inference_mode():
        got = ab.attn_block_cuda(*args)
        again = ab.attn_block_cuda(*args)
        want = ab.attn_block_reference(*args)
    torch.cuda.synchronize()
    errs = {}
    for name, k, r in zip(("out", "ctx", "lse"), got, want):
        k, r = k.float(), r.float()
        check(bool(torch.isfinite(k).all()), f"attn_block {name} has non-finite values")
        err = (k - r).abs().max().item()
        # Both sides round q/k/v, P and the outputs to bf16 after fp32 sums
        # taken in another order, so a one-ulp flip of q/k/v travels through
        # the softmax and two more products: allow 8 bf16 ulps at the
        # output's largest magnitude for out and ctx.  lse stays fp32 and
        # sees those flips only through q.k: allow 2 bf16 ulps of its largest.
        ulps = 2 if name == "lse" else 8
        tol = ulps * bf16_ulp(r.abs().max().item())
        print(f"parity attn_block B={b} S={s} ln={fuse_ln}{mtag} {name}: max_abs_err={err:.3e} "
              f"tol={tol:.3e} ({ulps} bf16 ulps at max |ref|={r.abs().max().item():.3e})")
        check(err <= tol, f"attn_block {name} disagrees with the plain version: {err} > {tol}")
        errs[name] = err
    for name, k, r in zip(("out", "ctx"), got, want):
        ulps = own_ulps(torch, k, r)
        bad = k.float().clone()
        bad[0, 0] += r.float().pow(2).mean().sqrt()  # one row off by a typical |r|
        p_ulps = own_ulps(torch, bad, r)
        print(f"parity attn_block B={b} S={s} ln={fuse_ln}{mtag} {name}: {ulps:.2f} own ulps (limit "
              f"{ATTN_OWN_ULPS}); planted fault (row 0 off by the rms) {p_ulps:.1f} ulps")
        check(ulps <= ATTN_OWN_ULPS < p_ulps,
              f"attn_block {name} disagrees with the plain version: {ulps} own ulps (limit {ATTN_OWN_ULPS})")
    stable = all(torch.equal(k, c) for k, c in zip(got, again))
    print(f"parity attn_block B={b} S={s} ln={fuse_ln}{mtag}: second call bitwise equal: {stable}")
    check(stable, f"attn_block B={b} S={s} ln={fuse_ln}{mtag} is not bitwise stable across two calls")
    attn_qkv_plane(torch, args)
    return max(errs.values())


def attn_qkv_plane(torch, args):
    """#1's q/k/v plane (the first 3 M Dm bf16 of the C entry point
    ``attn_block_fwd``'s workspace) against #3's recompute of it (the first
    3 M Dm bf16 of ``attn_block_bwd``'s workspace): one row pass for LN1 and
    one GEMM launch on both sides, so they must be bitwise equal, and the
    backward's p = exp(s - lse) is rebuilt from the forward's own logits."""
    from feddat_tpu_torch.ops import attn_block as ab
    from feddat_tpu_torch.ops._build import ptr

    x, wq, wk, wv, wo, bqkv, bo, gb, bias, heads, scale, ln_eps = args
    b, s, dm = x.shape
    brow = None if bias is None else ab._key_bias(bias, b, s).contiguous()
    fws = torch.empty(ab._fwd_workspace(b, s, dm, 0), dtype=torch.uint8, device="cuda")
    qkv = fws[: 3 * b * s * dm * 2].view(torch.bfloat16).view(3, b * s, dm)
    ctx, out = torch.empty_like(x), torch.empty_like(x)
    lse = torch.empty((b, heads, s), dtype=torch.float32, device="cuda")
    ws = torch.empty(ab._bwd_workspace(b, s, dm, heads, gb is not None, 0), dtype=torch.uint8,
                     device="cuda")
    g = torch.randn(x.shape, generator=torch.Generator(device="cuda").manual_seed(s), device="cuda").bfloat16()
    dx = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    eps = float(ln_eps or 0.0)
    ab.KERNEL.launch(ptr(x), ptr(wq), ptr(wk), ptr(wv), ptr(wo), ptr(bqkv), ptr(bo), ptr(gb), ptr(brow),
                     ptr(fws), ptr(ctx), ptr(lse), ptr(out), b, s, dm, heads, 0, float(scale), eps, stream)
    ab.KERNEL_BWD.launch(ptr(x), ptr(wq), ptr(wk), ptr(wv), ptr(wo), ptr(bqkv), ptr(gb), ptr(brow),
                         ptr(ctx), ptr(lse), ptr(g), ptr(ws), ptr(dx), b, s, dm, heads, 0, float(scale),
                         eps, stream)
    torch.cuda.synchronize()
    recomputed = ws[: qkv.numel() * 2].view(torch.bfloat16).view_as(qkv)
    same = torch.equal(qkv, recomputed)
    print(f"parity attn_block B={b} S={s} ln={gb is not None}: q/k/v plane bitwise equal to #3's "
          f"recompute: {same}")
    check(same, f"attn_block B={b} S={s}: #1's q/k/v differ from #3's recompute")


# #2's ragged row counts (the edges of its 64-row cluster tiles, the B=1
# bucket's 281 and the serving shape's 4496) and bottlenecks (R=12 is padded
# to 16 and read element by element, R=96 takes two 64-column atoms per adapter).
ADAPTER_ROWS = (17, 63, 64, 65, 127, 128, 129, S, 3 * 21, B * S)
ADAPTER_BOTTLENECKS = (R, 12, 96)
# (R, D) past the first design's R <= 128 and D <= 1024: the bottleneck walked
# in chunks (R=192 two of 96 at a DAT ensemble's reduction 4, R=384 three of
# 128, R=196 two of 112 with Wd read element by element), and wider models
# (D=1280 with R=80, D=2048 with R=128: one chunk, K slices of 320 and 512),
# each at the row counts of ADAPTER_WIDE_ROWS.
ADAPTER_WIDE = ((192, DM), (384, DM), (196, DM), (80, 1280), (128, 2048))
ADAPTER_WIDE_ROWS = (17, 65, 129, S, B * S)


def adapter_parity(torch, n, seed, r=R, d=DM):
    """#2 against its plain version: every element within one bf16 ulp
    (2^-7 |ref| + 1e-6), a planted fault caught, a second call bitwise equal."""
    from feddat_tpu_torch.ops import adapter_fused as af

    h, pa, pb, w = adapter_inputs(torch, n, seed, r, d)
    with torch.inference_mode():
        got = af.adapter_fused_cuda(h, pa, pb, w)
        again = af.adapter_fused_cuda(h, pa, pb, w)
        want = af.adapter_fused_reference(h, pa, pb, w).float()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "adapter_fused has non-finite values")
    # both sides do fp32 math and round once to bf16: they may differ by one
    # bf16 ulp where the fp32 sums land on either side of a rounding point
    limit = 2.0 ** -7 * want.abs() + 1e-6
    err = (got.float() - want).abs()
    bad = (err > limit).sum().item()
    planted = got.float().clone()
    planted[-1] += want.pow(2).mean().sqrt()  # the last row off by the rms
    caught = ((planted - want).abs() > limit).sum().item()
    stable = torch.equal(got, again)
    tag = f"N={n} R={r}" + ("" if d == DM else f" D={d}")
    print(f"parity adapter_fused {tag}: max_abs_err={err.max().item():.3e} "
          f"elements beyond one bf16 ulp (2^-7 |ref| + 1e-6): {bad}; planted fault (last row off "
          f"by the rms) {caught} of {d}; second call bitwise equal: {stable}")
    check(bad == 0, f"adapter_fused {tag} disagrees with the plain version in {bad} elements")
    check(caught > 0, f"adapter_fused {tag}: the limit did not catch the planted fault")
    check(stable, f"adapter_fused {tag} is not bitwise stable across two calls")
    return err.max().item()


def adapter_probe(torch, r=R, b_units=(5, 6)):
    """#2 on :func:`adapter_probe_inputs`: bitwise the plain fp32 version's,
    which is the exact 5 2^-20 (a two-part split of x would give 0)."""
    from feddat_tpu_torch.ops import adapter_fused as af

    h, pa, pb, w, exact = adapter_probe_inputs(torch, 65, r, b_units)
    with torch.inference_mode():
        got = af.adapter_fused_cuda(h, pa, pb, w)
        want = af.adapter_fused_reference(h, pa, pb, w)
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    print(f"parity adapter_fused probe R={r}, b's units {b_units} (ReLU outputs below a bf16 hi + lo pair): kernel "
          f"{got.float().unique().tolist()}, plain {want.float().unique().tolist()}, exact {exact!r}; "
          f"bitwise equal: {same}")
    check(same and bool((want.float() == exact).all()),
          "adapter_fused probe: the kernel drops bits of the ReLU output below bf16 hi + lo")


def layer_weights(torch, seed, ffn=None, r=R, dtype=None):
    """Frozen layer weights (FFN width ``ffn``, default :data:`FF`) and two
    adapters of bottleneck ``r`` on the card: bf16 (or ``dtype``) matrices,
    fp32 biases and LayerNorm rows drawn large (std 0.5-1) so that a dropped
    or misplaced bias or LN parameter moves the outputs far past the
    tolerances."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    ffn = ffn or FF

    def randn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g, device="cuda") * std).to(dtype)

    bf = dtype or torch.bfloat16
    ln = lambda: torch.stack([1.0 + randn(DM, std=0.5), randn(DM, std=0.5)])  # noqa: E731
    frozen = dict(
        wq=randn(DM, DM, std=0.04, dtype=bf), wk=randn(DM, DM, std=0.04, dtype=bf),
        wv=randn(DM, DM, std=0.04, dtype=bf), wo=randn(DM, DM, std=0.04, dtype=bf),
        bqkv=randn(3, DM), bo=randn(1, DM), gb1=ln(), gb2=ln(),
        w1=randn(ffn, DM, std=0.04, dtype=bf), b1=randn(1, ffn),
        w2=randn(DM, ffn, std=0.02, dtype=bf), b2=randn(1, DM, std=0.5),
    )
    adapters = [(randn(DM, r, std=0.05, dtype=bf), randn(1, r), randn(r, DM, std=0.05, dtype=bf),
                 randn(1, DM, std=0.5)) for _ in range(2)]
    return frozen, adapters


def padding_bias(torch, b, s, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    valid = torch.randint(max(1, s // 3), s + 1, (b, 1), generator=g, device="cuda")
    keys = torch.arange(s, device="cuda")[None, :]
    return ((keys >= valid).float() * -10000.0)[:, None, None, :]


def layer_case(torch, b, s, use_b, seed, masked=True, bias=None, r=R, dtype=None):
    """Residuals of one layer's forward on the card (layer_fwd: kernel #1 +
    plain ops) and a cotangent g at std 1, so that lse and ctx are the ones
    the backward really sees; -> (args of layer_block_bwd_*, cfg).  No
    padding bias when not ``masked``; adapters of bottleneck ``r``; bf16 or
    ``dtype``."""
    from feddat_tpu_torch.ops import layer_block as lb

    dt = dtype or torch.bfloat16
    w, ((wda, bda, wua, bua), (wdb, bdb, wub, bub)) = layer_weights(torch, seed, r=r, dtype=dt)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    x = torch.randn(b, s, DM, generator=g, device="cuda").to(dt)
    if bias is None:
        bias = padding_bias(torch, b, s, seed) if masked else None
    cfg = (HEADS, 64 ** -0.5, 1e-12, 1e-12, 0.5 if use_b else 1.0, 0.5 if use_b else 0.0, use_b)
    with torch.no_grad():
        _, (_, ctx, lse, aout) = lb.layer_fwd(
            x, w["wq"], w["wk"], w["wv"], w["wo"], w["bqkv"], w["bo"], w["gb1"], w["gb2"],
            w["w1"], w["b1"], w["w2"], w["b2"], wda, bda, wua, bua, wdb, bdb, wub, bub, bias, *cfg)
    gout = torch.randn(b, s, DM, generator=g, device="cuda").to(dt)
    args = (x, aout, ctx, lse, gout, bias, w["wq"], w["wk"], w["wv"], w["wo"], w["bqkv"],
            w["gb1"], w["gb2"], w["w1"], w["b1"], w["w2"], w["b2"],
            wda, bda, wua, bua, wdb, bdb, wub, bub)
    return args, cfg


def attn_bwd_case(torch, b, s, fuse_ln, seed, masked=True, dtype=None):
    """Kernel #1's residuals on the card and a cotangent at std 1 ->
    args of attn_block_bwd_* (x, weights, bqkv, gb, bias, ctx, lse, g, ...)."""
    from feddat_tpu_torch.ops import attn_block as ab

    x, wq, wk, wv, wo, bqkv, bo, gb, bias, heads, scale, ln_eps = attn_inputs(
        torch, b, s, fuse_ln, seed, masked, dtype=dtype)
    if fuse_ln:  # LayerNorm rows drawn large, as for the layer
        gen = torch.Generator(device="cuda").manual_seed(seed + 2)
        gb = torch.stack([1.0 + 0.5 * torch.randn(DM, generator=gen, device="cuda"),
                          0.5 * torch.randn(DM, generator=gen, device="cuda")])
    with torch.no_grad():
        _, ctx, lse = ab.attn_block_cuda(x, wq, wk, wv, wo, bqkv, bo, gb, bias, heads, scale, ln_eps)
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    gout = torch.randn(b, s, DM, generator=gen, device="cuda").to(x.dtype)
    return (x, wq, wk, wv, wo, bqkv, gb, bias, ctx, lse, gout, heads, scale, ln_eps)


def rel_norm(k, r) -> float:
    """||k - r|| / ||r|| over all elements, in fp32."""
    k, r = k.float(), r.float()
    return ((k - r).norm() / r.norm()).item()


def own_ulps(torch, k, r, floor: float = 0.0) -> float:
    """Largest |k - r| in bf16 ulps of each element's own |r|, the ulp taken
    at no less than the rms of r (an element near 0 is held at the ulp of a
    typical one, not at ~0) nor than ``floor``."""
    k, r = k.float(), r.float()
    mag = torch.maximum(r.abs(), r.pow(2).mean().sqrt().clamp_min(floor))
    return ((k - r).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max().item()


# Limits of the backward kernels against their plain versions, set from this
# phase's readings on the card over seeds 0-2 at B=64, S=185 and the ragged
# cases (PERF.md, PR 2): above the largest sound reading, below the planted
# faults that the phase also reads.  Both sides round to bf16 at the same
# points after fp32 sums taken in another order.
#   #3 dx, elementwise in bf16 ulps of each element's own magnitude: sound
#   <= 16 (one element at seed 0; <= 6 elsewhere), planted (one row off by
#   the rms) >= 131: limit 32.
#   #4, stage by stage.  o (the FFN recompute): 0.3-0.5% of the elements
#   differ, by <= 2 ulps (the tensor cores sum p1 and f as cuBLAS's bf16
#   GEMM does, not as its fp32 one): limit 4.  The kernel's ReLU gate
#   matched down > 0 on its own o everywhere; it may differ only where |down|
#   is rounding noise (1e-3 of max |down|).  On the kernel's o and gate the
#   adapter gradients read <= 7.8e-5 in relative norm and g_o <= 2.3e-5:
#   limits 5e-4 and 2e-4 (a 10% scale or one dropped 256-row chunk reads
#   >= 0.1).  dx from the kernel's g_o (steps 4-7), as #3's dx: <= 15 ulps,
#   planted >= 135: limit 32.
#   End to end, each output by relative norm.  There the two sides' o
#   differ, and at 15-29 gate entries (B=64) down_a lies within that of 0,
#   so whole rows of g_down move by |g_relu|: dwda and dbda read <= 1.3e-2,
#   dx <= 4.6e-3, dwua <= 8.5e-4, dbua <= 1.1e-7; planted >= 0.099.
ATTN_DX_ULPS = 32
LAYER_STAGE_LIMITS = {"o_ulps": 4, "gate_noise": 1e-3, "adapter": 5e-4, "g_o": 2e-4, "dx_ulps": 32}
LAYER_E2E_LIMITS = {"dx": 1e-2, "dwda": 3e-2, "dbda": 3e-2, "dwua": 2e-3, "dbua": 1e-6}
PLANTED_CHUNK = 256  # rows of one partial-sum chunk of #4 (at most half the rows)


def attn_bwd_parity(torch, b, s, fuse_ln, seed, masked=True):
    from feddat_tpu_torch.ops import attn_block as ab

    args = attn_bwd_case(torch, b, s, fuse_ln, seed, masked)
    with torch.no_grad():
        got = ab.attn_block_bwd_cuda(*args).float()
        again = ab.attn_block_bwd_cuda(*args).float()
        want = ab.attn_block_bwd_reference(*args).float()
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"attn_block_bwd B={b} S={s} ln={fuse_ln}{'' if masked else ' unmasked'} is not bitwise stable "
          "across two calls")
    check(bool(torch.isfinite(got).all()), "attn_block_bwd dx has non-finite values")
    err, ulps = (got - want).abs().max().item(), own_ulps(torch, got, want)
    planted = got.clone()
    planted[0, 0] += want.pow(2).mean().sqrt()  # one row off by a typical |dx|
    p_ulps = own_ulps(torch, planted, want)
    print(f"parity attn_block_bwd B={b} S={s} ln={fuse_ln}{'' if masked else ' unmasked'} dx: {ulps:.2f} own ulps (limit "
          f"{ATTN_DX_ULPS}), rel norm {rel_norm(got, want):.2e}, max_abs_err={err:.3e}; planted "
          f"fault (row 0 off by the rms) {p_ulps:.1f} ulps; second call bitwise equal")
    check(ulps <= ATTN_DX_ULPS < p_ulps,
          f"attn_block_bwd dx disagrees with the plain version: {ulps} ulps (limit {ATTN_DX_ULPS})")
    return err


def layer_bwd_parity(torch, b, s, use_b, seed, masked=True, bias=None, r=R):
    """#4 against its plain version, stage by stage and end to end (see the
    limits above); prints the o elements and gate entries where the kernel
    and the plain version differ, and p1's deviation beside cuBLAS's bf16
    tensor-core GEMM's.  The adapter gradients must be bitwise the same on a
    second call.  Adapters of bottleneck ``r`` (the kernel's stages hold the
    padded bottleneck; its first ``r`` columns are the adapter's)."""
    from feddat_tpu_torch.ops import layer_block as lb

    tag = (f"parity layer_block_bwd B={b} S={s} ensemble={use_b}{mask_tag(masked, bias)}"
           + ("" if r == R else f" R={r}"))
    args, cfg = layer_case(torch, b, s, use_b, seed, masked, bias, r)
    (x, aout, ctx, lse, g, bias, wq, wk, wv, wo, bqkv, gb1, gb2, w1, b1, w2, b2,
     wda, bda, wua, bua, wdb, bdb, wub, bub) = args
    heads, scale, eps1, eps2, w_a, w_b, _ = cfg
    lim = LAYER_STAGE_LIMITS
    with torch.no_grad():
        got, st = lb.layer_block_bwd_cuda_stages(*args, *cfg)
        again = lb.layer_block_bwd_cuda(*args, *cfg)
        want = lb.layer_block_bwd_reference(*args, *cfg)
        for name, k in zip(("dx", "dwda", "dbda", "dwua", "dbua"), got):
            check(bool(torch.isfinite(k).all()), f"layer_block_bwd {name} has non-finite values")

        # steps 1-2: the FFN recompute
        _, xhat2, rstd2, p1, o = lb.ffn_recompute_reference(x, aout, gb2, w1, b1, w2, b2, eps2)
        o, o_k, m_k = o.reshape(-1, DM), st["o"], st["m"]
        p1_fp32 = m_k.float() @ w1.float().t() + b1[0]
        p1_cublas = torch.mm(m_k, w1.t(), out_dtype=torch.float32) + b1[0]
        top = p1_fp32.abs().max().item()
        o_ulps, o_diff = own_ulps(torch, o_k, o), int((o_k != o).sum())
        print(f"{tag} o: {o_diff} of {o.numel()} elements differ ({100 * o_diff / o.numel():.3f}%), "
              f"{o_ulps:.2f} own ulps (limit {lim['o_ulps']}); p1 on the kernel's m, max |diff| "
              f"from fp32 cuBLAS / max |p1|: kernel {(st['p1'] - p1_fp32).abs().max().item() / top:.2e}, "
              f"cuBLAS bf16 tensor cores {(p1_cublas - p1_fp32).abs().max().item() / top:.2e}")
        check(o_ulps <= lim["o_ulps"], f"layer_block_bwd o disagrees: {o_ulps} ulps")

        # step 3: the kernel's gate against down_a > 0 on its own o and on the plain o
        gate = st["relu_a"][:, :r] > 0
        down_k = o_k.float() @ wda.float() + bda[0]
        down_r = o.float() @ wda.float() + bda[0]
        flips = gate != (down_k > 0)
        noise = down_k[flips].abs().max().item() / down_k.abs().max().item() if flips.any() else 0.0
        print(f"{tag} gate_a: {int(flips.sum())} of {gate.numel()} entries differ from down > 0 on "
              f"the kernel's o (largest |down| there {noise:.2e} of max |down|, limit "
              f"{lim['gate_noise']:.0e}), {int((gate != (down_r > 0)).sum())} on the plain o")
        check(noise <= lim["gate_noise"], f"layer_block_bwd gate differs where |down| = {noise}")

        # step 3: the adapter gradients and g_o on the kernel's o and gate
        g2 = g.reshape(-1, DM)
        relu, g_delta, g_down = lb.adapter_bwd_reference(o_k, g2, wda, bda, wua, w_a, gate)
        stage = lb.adapter_wgrads_reference(o_k, relu, g_delta, g_down)
        g_o = g2.float() + g_down.bfloat16().float() @ wda.float().t()
        if use_b:
            g_down_b = lb.adapter_bwd_reference(o_k, g2, wdb, bdb, wub, w_b)[2]
            g_o = g_o + g_down_b.bfloat16().float() @ wdb.float().t()
        errs = {name: rel_norm(k, r) for name, k, r in
                zip(("dwda", "dbda", "dwua", "dbua"), got[1:], stage)}
        errs["g_o"] = rel_norm(st["g_o"], g_o)
        print(f"{tag} stage 3 on the kernel's o and gate, rel norm: "
              + ", ".join(f"{n} {v:.2e}" for n, v in errs.items())
              + f" (limits {lim['adapter']:.0e}, g_o {lim['g_o']:.0e})")
        check(max(v for n, v in errs.items() if n != "g_o") <= lim["adapter"] and errs["g_o"] <= lim["g_o"],
              f"layer_block_bwd adapter stage disagrees: {errs}")

        # steps 4-7 from the kernel's g_o
        dx_tail = lb.layer_tail_bwd_reference(
            st["g_o"].view(b, s, DM), xhat2, rstd2, st["p1"].view(b, s, -1), x, ctx, lse, bias,
            wq, wk, wv, wo, bqkv, gb1, gb2, w1, w2, heads, scale, eps1)
        dx_ulps = own_ulps(torch, got[0], dx_tail)
        planted_dx = got[0].float()
        planted_dx[0, 0] += dx_tail.float().pow(2).mean().sqrt()  # one row off by a typical |dx|
        p_ulps = own_ulps(torch, planted_dx, dx_tail)
        print(f"{tag} steps 4-7 from the kernel's g_o: dx {dx_ulps:.2f} own ulps (limit "
              f"{lim['dx_ulps']}); planted fault (row 0 off by the rms) {p_ulps:.1f} ulps")
        check(dx_ulps <= lim["dx_ulps"] < p_ulps, f"layer_block_bwd dx disagrees: {dx_ulps} ulps")

        # end to end, with planted faults that the limits must catch
        e2e = {name: rel_norm(k, r) for name, k, r in
               zip(("dx", "dwda", "dbda", "dwua", "dbua"), got, want)}
        n = min(PLANTED_CHUNK, b * s // 2)
        planted = {
            "dwda x 0.9": rel_norm(0.9 * got[1], want[1]),
            f"dwda without rows 0-{n - 1}":
                rel_norm(got[1] - o_k[:n].float().t() @ st["g_down_a"][:n, :r].bfloat16().float(), want[1]),
            f"dbua without rows 0-{n - 1}": rel_norm(got[4] - g_delta[:n].float().sum(0), want[4]),
        }
        print(f"{tag} end to end, rel norm: " + ", ".join(f"{k} {v:.2e}" for k, v in e2e.items())
              + f"; max_abs_err dx {(got[0].float() - want[0].float()).abs().max().item():.3e}; "
              + "planted: " + ", ".join(f"{k} {v:.2e}" for k, v in planted.items()))
        for name, v in e2e.items():
            check(v <= LAYER_E2E_LIMITS[name], f"layer_block_bwd {name} disagrees: rel norm {v}")
        check(all(v > LAYER_E2E_LIMITS[k.split()[0]] for k, v in planted.items()),
              f"a planted fault passes the end-to-end limits: {planted}")
    stable = all(torch.equal(a, c) for a, c in zip(got, again))
    print(f"{tag}: second call bitwise equal: {stable}")
    check(stable, "layer_block_bwd is not bitwise stable across two calls")
    return (got[0].float() - want[0].float()).abs().max().item()


def fused_inputs(torch, b, s, seed, layout="split", dtype=None):
    """q, k, v and a cotangent dO [B, H, S, 64] bf16 (or ``dtype``) on the
    card at std 1 (logits q.k^T/8 at std 1).  ``split``: the [B, H, S, 64] views that
    MultiHeadAttention's split() makes of [B, S, Dm] projections (strides S Dm,
    64, Dm, 1), as the main path hands them over; ``contiguous``: [B, H, S, 64]
    tensors."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def heads():
        if layout == "split":
            t = torch.randn(b, s, DM, generator=g, device="cuda").to(dtype or torch.bfloat16)
            return t.view(b, s, HEADS, DM // HEADS).transpose(1, 2)
        return torch.randn(b, HEADS, s, DM // HEADS, generator=g, device="cuda").to(dtype or torch.bfloat16)

    return heads(), heads(), heads(), heads()


# #5 and #6 against their plain versions on the same inputs (#6 on the
# kernel's own o and lse, as the autograd path hands them over).  o, dq, dk, dv
# elementwise in bf16 ulps of each element's own magnitude (own_ulps), lse in
# fp32 as |err| / max |lse| of each batch element.  Limits set from this
# phase's readings on the card over seeds 0-2 at the first five shapes (PERF.md
# §6, #5/#6): above the largest sound reading, below the planted faults that
# the phase also reads (one row off by the rms; lse of one row off by 1e-3).
# Sound: o <= 2 own ulps, lse <= 1.6e-7, dq/dk/dv <= 4; planted: >= 128 ulps,
# lse >= 1.4e-4.
FUSED_LIMITS = {"o": 8, "lse": 1e-5, "dq": 16, "dk": 16, "dv": 16}
# S at the edges of #5's and #6's 64-row tiles (one batch element, 12 heads)
FUSED_EDGE_LENGTHS = (63, 64, 65, 127, 128, 129)


def fused_parity(torch, b, s, seed, batch1=False, layout="split", mask_all=False):
    """#5 and #6 at one shape; ``mask_all`` puts -10000 on every key of batch
    element 0 (its rows are then the unbiased softmax, as on the TPU)."""
    from feddat_tpu_torch.ops import fused_attention as fa

    q, k, v, do = fused_inputs(torch, b, s, seed, layout)
    bias = padding_bias(torch, 1 if batch1 else b, s, seed)
    if mask_all:
        bias[0] = -10000.0
    scale = 64 ** -0.5
    tag = (f"parity fused_attention B={b} S={s} bias={'[1,1,1,S]' if batch1 else '[B,1,1,S]'} {layout}"
           + (" element 0 fully masked" if mask_all else ""))
    with torch.no_grad():
        o, lse = fa.fused_attention_fwd_cuda(q, k, v, bias, scale)
        again = fa.fused_attention_fwd_cuda(q, k, v, bias, scale)
        o_r, lse_r = fa.fused_attention_fwd_ref(q, k, v, bias, scale)
        grads = fa.fused_attention_bwd_cuda(q, k, v, bias, o, do, lse, scale)
        grads_again = fa.fused_attention_bwd_cuda(q, k, v, bias, o, do, lse, scale)
        grads_r = fa.fused_attention_bwd_ref(q, k, v, bias, o, do, lse, scale)
    torch.cuda.synchronize()
    readings, planted = {}, {}
    for name, got, want in (("o", o, o_r), *zip(("dq", "dk", "dv"), grads, grads_r)):
        check(bool(torch.isfinite(got.float()).all()), f"fused_attention {name} has non-finite values")
        readings[name] = own_ulps(torch, got, want)
        bad = got.float().clone()
        bad[0, 0, 0] += want.float().pow(2).mean().sqrt()  # one row off by a typical |value|
        planted[name] = own_ulps(torch, bad, want)
    # lse per batch element against that element's largest |lse|, so that a
    # fully masked element (lse near -10000) does not hide the others' errors;
    # the planted fault goes into the last element
    top = lse_r.abs().amax(dim=(1, 2))

    def lse_err(t):
        return ((t - lse_r).abs().amax(dim=(1, 2)) / top).max().item()

    readings["lse"] = lse_err(lse)
    bad = lse.clone()
    bad[-1, 0, 0] += 1e-3
    planted["lse"] = lse_err(bad)
    print(f"{tag}: " + ", ".join(f"{n} {readings[n]:.3g} (limit {FUSED_LIMITS[n]:g}, planted "
                                 f"{planted[n]:.3g})" for n in FUSED_LIMITS)
          + f"; rel norm o {rel_norm(o, o_r):.2e} dq {rel_norm(grads[0], grads_r[0]):.2e} "
          f"dk {rel_norm(grads[1], grads_r[1]):.2e} dv {rel_norm(grads[2], grads_r[2]):.2e}")
    for n, lim in FUSED_LIMITS.items():
        check(readings[n] <= lim < planted[n],
              f"fused_attention {n} disagrees with the plain version: {readings[n]} (limit {lim}, "
              f"planted {planted[n]})")
    stable = torch.equal(o, again[0]) and torch.equal(lse, again[1]) and all(
        torch.equal(a, c) for a, c in zip(grads, grads_again))
    print(f"{tag}: second calls bitwise equal: {stable}")
    check(stable, "fused_attention is not bitwise stable across two calls")
    fwd_err = max((o.float() - o_r.float()).abs().max().item(), (lse - lse_r).abs().max().item())
    bwd_err = max((a.float() - r.float()).abs().max().item() for a, r in zip(grads, grads_r))
    return fwd_err, bwd_err


def fused_probes(torch):
    """The bf16 rounding points of #5 and #6, through the CUDA entry points at
    d=64, each against the plain version bitwise.
    P: two keys with logits 0 (key 0) and 2^-10 (key 100, in the second 64-key
      tile; every other key masked) and values +1000 and -1000.  p = e^(-2^-10)
      and 1 are both 1.0 in bf16, so bf16(P).v gives o = 0 exactly; an fp32 P,
      or a running max that meets the larger logit only in the second tile,
      would not.
    ds: lse given as 0 and q, k on disjoint dims, so every p is exactly 1; dO =
      e0 on both queries, v0 = e0, v1 = 2 e0, o_a = 3 * 2^-10 e0 and o_b = 0, so
      ds_a = (1 - 3u, 2 - 3u) (u = 2^-10) round to (1 - 4u, 2) in bf16 and ds_b
      = (1, 2) are exact.  With k1 = -k0/2 and q_b = -q_a, dq_a = scale (ds_a0
      - ds_a1 / 2) and dk = scale (ds_a - ds_b) q_a read -2^-11, -2^-11 and 0
      with ds rounded, -1.5 u / 8, -3 u / 8 and -3 u / 8 without.  Every
      sum is exact in fp32, so the kernel and the plain version agree bitwise
      whatever their order of summation."""
    from feddat_tpu_torch.ops import fused_attention as fa

    def zeros(s):
        return torch.zeros(1, 1, s, 64, dtype=torch.bfloat16, device="cuda")

    s = 129
    q, k, v = zeros(s), zeros(s), zeros(s)
    q[..., 0] = 1.0
    k[0, 0, 100, 0] = 2.0 ** -8  # logits q.k/4: 0 and 2^-10
    v[0, 0, 0, :], v[0, 0, 100, :] = 1000.0, -1000.0
    bias = torch.full((1, 1, 1, s), -10000.0, device="cuda")
    bias[..., 0] = bias[..., 100] = 0.0
    with torch.no_grad():
        o, lse = fa.fused_attention_fwd_cuda(q, k, v, bias, 0.25)
        o_r, lse_r = fa.fused_attention_fwd_ref(q, k, v, bias, 0.25)
    torch.cuda.synchronize()
    p_ok = torch.equal(o, o_r) and not o.float().any().item()
    print(f"parity fused_attention P probe: max |o| {o.float().abs().max().item():g} (plain version "
          f"{o_r.float().abs().max().item():g}; bf16(P) gives 0), lse {lse[0, 0, 0].item():.6f} "
          f"(plain {lse_r[0, 0, 0].item():.6f})")

    q, k, v, o, do = zeros(2), zeros(2), zeros(2), zeros(2), zeros(2)
    q[0, 0, 0, 32], q[0, 0, 1, 32] = 1.0, -1.0
    k[0, 0, 0, 0], k[0, 0, 1, 0] = 1.0, -0.5
    v[0, 0, 0, 0], v[0, 0, 1, 0] = 1.0, 2.0
    o[0, 0, 0, 0] = 3 * 2.0 ** -10
    do[0, 0, :, 0] = 1.0
    lse = torch.zeros(1, 1, 2, device="cuda")
    with torch.no_grad():
        got = fa.fused_attention_bwd_cuda(q, k, v, None, o, do, lse, 0.125)
        want = fa.fused_attention_bwd_ref(q, k, v, None, o, do, lse, 0.125)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    dq, dk = got[0][0, 0, 0, 0].item(), (got[1][0, 0, 0, 32].item(), got[1][0, 0, 1, 32].item())
    ds_ok = same and dq == -2.0 ** -11 and dk == (-2.0 ** -11, 0.0)
    print(f"parity fused_attention ds probe: dq_a0 {dq!r}, dk_0 {dk[0]!r}, dk_1 {dk[1]!r} (bf16(ds) gives "
          f"{-2.0 ** -11!r}, {-2.0 ** -11!r}, 0.0; fp32 ds {-1.5 * 2.0 ** -10 / 8!r}, "
          f"{-3 * 2.0 ** -10 / 8!r}, {-3 * 2.0 ** -10 / 8!r}); equal to the plain version: {same}")
    check(p_ok, "fused_attention: o of the P probe is not exactly 0 or not the plain version's")
    check(ds_ok, "fused_attention_bwd: the ds probe is not bf16(ds)'s result or not the plain version's")


def flash_case(torch, b, sq, skv, kind, seed, dtype=None):
    """#7 inputs on the card: q [B, H, Sq, 64] and k, v [B, H, Skv, 64] bf16 (or
    ``dtype``) as the split() views of [B, S, Dm] projections (std 1: logits q.k^T/8 at std
    1), and the compact fp32 bias of one of ALBEF's layouts: ``none`` (ViT),
    ``padding`` [B,1,1,Skv] (text self-attention, stage-1 and grouped cross),
    ``zero`` [B,1,1,Skv] (fusion cross: every image token), ``packed``
    [B,1,Sq,Skv] (the stage-2 decoder, 8 causal answers per row, each padded
    to a random length), ``causal`` [B,1,Sq,Skv] (the training decoder: causal
    plus padding) and ``heads`` [1,H,Sq,Skv] (random, the head-dim layout of
    _prep_bias that no ALBEF site has)."""
    from feddat_tpu_torch.ops.attention import causal_bias, packed_self_bias

    g = torch.Generator(device="cuda").manual_seed(seed)

    def heads(s):
        t = torch.randn(b, s, DM, generator=g, device="cuda").to(dtype or torch.bfloat16)
        return t.view(b, s, HEADS, DM // HEADS).transpose(1, 2)

    q, k, v = heads(sq), heads(skv), heads(skv)
    if kind == "none":
        bias = None
    elif kind == "padding":
        bias = padding_bias(torch, b, skv, seed)
    elif kind == "zero":
        bias = torch.zeros(b, 1, 1, skv, device="cuda")
    elif kind == "packed":
        la = sq // PACK
        lengths = torch.randint(1, la + 1, (b * PACK, 1), generator=g, device="cuda")
        mask = (torch.arange(la, device="cuda")[None, :] < lengths).int()
        bias = packed_self_bias(mask, PACK, True)
    elif kind == "heads":
        bias = torch.randn(1, HEADS, sq, skv, generator=g, device="cuda")
    elif kind == "causal":
        bias = padding_bias(torch, b, skv, seed) + causal_bias(skv, device="cuda")
    else:
        raise ValueError(kind)
    return q, k, v, bias


# #7 at ALBEF's attention sites (B=16 requests, 12 heads): (site, B, Sq, Skv, bias)
FLASH_CASES = [
    ("vit", AB, VIT_S, VIT_S, "none"),
    ("text self", AB, LQ, LQ, "padding"),
    ("fusion cross", AB, LQ, VIT_S, "zero"),
    ("stage-1 self", AB, 1, 1, "padding"),
    ("stage-1 cross", AB, 1, LQ, "padding"),
    ("stage-2 packed self", AB * ALBEF_K // PACK, PACK * LA, PACK * LA, "packed"),
    ("stage-2 grouped cross", AB, ALBEF_K * LA, LQ, "padding"),
    ("long", 2, 2048, 2048, "padding"),
    ("ragged head bias", 3, 130, 70, "heads"),
]
# The flash kernels' tile edges (128 rows per block, 64 per ring stage): Sq or
# Skv of 127, 128, 129 and 257, where a warpgroup or a ring stage is partly or
# wholly empty, with a padding bias (a staged key row) and the per-head one (a
# staged [query][key] tile).  Forward (Sq, Skv), backward (Skv, Sq) and, for
# #8, (Sq, 193) again: each edge falls on the side that each kernel splits into
# blocks and on the side that it streams.
EDGE_LENGTHS = (127, 128, 129, 257)
FLASH_EDGE_CASES = [(f"edge {n} {kind}", 2, n, 193 if kind == "heads" else n, kind)
                    for n in EDGE_LENGTHS for kind in ("padding", "heads")]
FLASH_CASES += FLASH_EDGE_CASES
# prompt tuning's fusion cross-attention: the ViT's 577 tokens and 5 prompt
# tokens, a key length off the 64-key ring stage
FLASH_CASES += [("fusion cross, prompt", AB, LQ, VIT_S + 5, "zero")]
# #7 against its plain version on the same inputs: o elementwise in bf16 ulps of
# each element's own magnitude (own_ulps), lse as |err| / max |lse|.  Both keep
# P in fp32 (the kernel as bf16 hi + lo, ~2^-16 of P) and round o to bf16 once
# after fp32 sums taken in another order.  Limits set from this phase's
# readings on the card over two seeds at all nine shapes (PERF.md §6, #7):
# sound o <= 1 own ulp, lse <= 2.3e-7; planted faults (one row off by the rms;
# lse of one row off by 1e-3) >= 130 ulps and >= 1.1e-4.  A P rounded to bf16
# reads only 1-2 ulps at these random inputs, so flash_p_probe holds P's
# precision with a constructed case instead.
FLASH_LIMITS = {"o": 4, "lse": 1e-5}


def flash_parity(torch, site, b, sq, skv, kind, seed):
    from feddat_tpu_torch.ops import flash as fl

    q, k, v, bias = flash_case(torch, b, sq, skv, kind, seed)
    scale = 64 ** -0.5
    with torch.no_grad():
        o, lse = fl.flash_attention_fwd_cuda(q, k, v, bias, scale)
        again = fl.flash_attention_fwd_cuda(q, k, v, bias, scale)
        o_r, lse_r = fl.flash_attention_fwd_ref(q, k, v, bias, scale)
        # the same function with P rounded to bf16 before P.v (as #5 does)
        s = (q.float() * scale) @ k.float().transpose(-1, -2) + (0.0 if bias is None else bias)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        o_p16 = (p.bfloat16().float() @ v.float() / p.sum(-1, keepdim=True)).bfloat16()
        del s, p
    torch.cuda.synchronize()
    check(bool(torch.isfinite(o.float()).all() and torch.isfinite(lse).all()),
          f"flash_attention {site}: non-finite values")
    readings = {"o": own_ulps(torch, o, o_r),
                "lse": (lse - lse_r).abs().max().item() / lse_r.abs().max().item()}
    bad = o.float().clone()
    bad[0, 0, 0] += o_r.float().pow(2).mean().sqrt()
    bad_lse = lse.clone()
    bad_lse[0, 0, 0] += 1e-3
    planted = {"o": own_ulps(torch, bad, o_r),
               "lse": (bad_lse - lse_r).abs().max().item() / lse_r.abs().max().item()}
    bias_desc = "none" if bias is None else list(bias.shape)
    print(f"parity flash_attention {site} B={b} H={HEADS} Sq={sq} Skv={skv} bias={bias_desc}: "
          + ", ".join(f"{n} {readings[n]:.3g} (limit {FLASH_LIMITS[n]:g}, planted {planted[n]:.3g})"
                      for n in FLASH_LIMITS)
          + f"; rel norm o {rel_norm(o, o_r):.2e}; a P rounded to bf16 would read "
          f"{own_ulps(torch, o_p16, o_r):.3g} ulps")
    for n, lim in FLASH_LIMITS.items():
        check(readings[n] <= lim < planted[n],
              f"flash_attention {site} {n} disagrees with the plain version: {readings[n]} "
              f"(limit {lim}, planted {planted[n]})")
    stable = torch.equal(o, again[0]) and torch.equal(lse, again[1])
    print(f"parity flash_attention {site}: second call bitwise equal: {stable}")
    check(stable, f"flash_attention {site} is not bitwise stable across two calls")
    return max((o.float() - o_r.float()).abs().max().item(), (lse - lse_r).abs().max().item())


def flash_p_probe(torch):
    """P stays fp32 in P.v: logits 0 and 2^-10 (p = e^(-2^-10) and 1, both 1.0
    in bf16) on values +1000 and -1000.  With fp32 P, o is about -0.4885; a P
    rounded to bf16 gives exactly 0."""
    from feddat_tpu_torch.ops import flash as fl

    q, k, v = (torch.zeros(1, 1, 2, 64, dtype=torch.bfloat16, device="cuda") for _ in range(3))
    q[..., 0] = 1.0
    k[0, 0, 1, 0] = 2.0 ** -8  # logits q.k/4: 0 and 2^-10
    v[0, 0, 0], v[0, 0, 1] = 1000.0, -1000.0
    with torch.no_grad():
        o, _ = fl.flash_attention_fwd_cuda(q, k, v, None, 0.25)
        o_r, _ = fl.flash_attention_fwd_ref(q, k, v, None, 0.25)
    torch.cuda.synchronize()
    got = o[0, 0, 0, 0].item()
    print(f"parity flash_attention P probe: o = {got:.6f} (plain version {o_r[0, 0, 0, 0].item():.6f}; "
          f"a P rounded to bf16 gives 0)")
    check(torch.equal(o, o_r) and abs(got + 0.4885) < 4e-3, "flash_attention rounds P below fp32")


def flash_refusals(torch):
    """On the card the wrappers of #7 and of #8/#9 raise, without launching, on
    what the kernels do not take (fp16, head dim 264, past the 256 they
    take; for the backward also a bias on another device): nothing falls
    back to a plain version.  The autograd function runs #7 forward and
    #8/#9 backward on CUDA tensors."""
    from feddat_tpu_torch.ops import flash as fl

    x = torch.zeros(1, 2, 8, 64, device="cuda", dtype=torch.bfloat16)
    wide = torch.zeros(1, 2, 8, 264, device="cuda", dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 8, device="cuda")
    kernels = (fl.KERNEL, fl.KERNEL_BWD_DQ, fl.KERNEL_BWD_DKV)
    before = [k.launches for k in kernels]
    refused = 0
    for bad, err in ((x.half(), TypeError), (wide, ValueError)):
        try:
            fl.flash_attention_fwd_cuda(bad, bad, bad, None, 0.125)
        except err:
            refused += 1
    for bad, bias, err in ((x.half(), None, TypeError), (wide, None, ValueError),
                           (x, torch.zeros(1, 1, 1, 8), ValueError)):
        try:
            fl.flash_attention_bwd_cuda(bad, bad, bad, bias, bad, bad, lse, 0.125)
        except err:
            refused += 1
    idle = [k.launches - b for k, b in zip(kernels, before)]
    leaves = [x.clone().requires_grad_() for _ in range(3)]
    fl.flash_attention(*leaves).float().sum().backward()
    torch.cuda.synchronize()
    ran = [k.launches - b for k, b in zip(kernels, before)]
    print(f"parity flash_attention refusals: fp16 and head dim 264 (forward and backward) and a CPU "
          f"bias (backward) refused {refused}/5 with launches {idle}; one autograd forward and "
          f"backward launched #7/#8/#9 {ran} times")
    check(refused == 5 and idle == [0, 0, 0] and ran == [1, 1, 1]
          and all(t.grad is not None for t in leaves),
          "flash attention accepts what it does not take, or its autograd path skips a kernel")


# The backward's training sites at ALBEF's batch (B=48, A=4 answers per
# question, 12 heads): (site, B, Sq, Skv, bias), then ragged lengths.
FLASH_BWD_CASES = [
    ("vit self", 48, VIT_S, VIT_S, "none"),
    ("text self", 48, LQ, LQ, "padding"),
    ("fusion cross", 48, LQ, VIT_S, "zero"),
    ("decoder self", 48 * 4, LA, LA, "causal"),
    ("decoder grouped cross", 48, 4 * LA, LQ, "padding"),
    ("Sq=Skv=1", 5, 1, 1, "padding"),
    ("Sq=1", 5, 1, LQ, "padding"),
    ("ragged head bias", 3, 130, 70, "heads"),
    ("ragged", 2, 67, 129, "padding"),
] + [(site, b, skv, sq, kind) for site, b, sq, skv, kind in FLASH_EDGE_CASES] + [
    # #8 splits the queries into 128-row blocks: the same edges there against
    # a staged per-head [query][key] bias tile
    (f"edge {n} heads, queries split", 2, n, 193, "heads") for n in EDGE_LENGTHS] + [
    ("fusion cross, prompt", 48, LQ, VIT_S + 5, "zero")]
# #8/#9 against their plain version on the same inputs, each of dq, dk, dv
# elementwise in bf16 ulps of each element's own magnitude (own_ulps).  Both
# keep p and ds at fp32 precision (the kernels as bf16 hi + lo) and round the
# gradients to bf16 once after fp32 sums taken in another order: limit 16, as
# #6's, with a planted fault (one row off by the rms) read every run.
FLASH_BWD_LIMIT = 16


def flash_bwd_parity(torch, site, b, sq, skv, kind, seed):
    """#8 (dq) and #9 (dk, dv) on the kernel forward's own o and lse, as the
    autograd path hands them over, and a cotangent dO in the split() layout."""
    from feddat_tpu_torch.ops import flash as fl

    q, k, v, bias = flash_case(torch, b, sq, skv, kind, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    do = torch.randn(b, sq, DM, generator=g, device="cuda").bfloat16()
    do = do.view(b, sq, HEADS, DM // HEADS).transpose(1, 2)
    scale = 64 ** -0.5
    with torch.no_grad():
        o, lse = fl.flash_attention_fwd_cuda(q, k, v, bias, scale)
        got = fl.flash_attention_bwd_cuda(q, k, v, bias, o, do, lse, scale)
        again = fl.flash_attention_bwd_cuda(q, k, v, bias, o, do, lse, scale)
        want = fl.flash_attention_bwd_ref(q, k, v, bias, o, do, lse, scale)
    torch.cuda.synchronize()

    def rms(t):
        return t.float().pow(2).mean().sqrt().item()

    # dq and dk are sums of ds = p (dP - delta), which vanishes where a query
    # has one key (p = 1, dP = delta): both sides then hold fp32 cancellation
    # noise only.  So each is held at no less than the ulp of 2^-8 of a typical
    # ds-sized term (scale |dP| |k| or |q|, |dP| ~ sqrt(64) |dO| |v|).
    term = scale * 8.0 * rms(do) * rms(v) * 2.0 ** -8
    floors = {"dq": term * rms(k), "dk": term * rms(q), "dv": 0.0}
    readings, planted = {}, {}
    for name, kk, r in zip(("dq", "dk", "dv"), got, want):
        check(bool(torch.isfinite(kk.float()).all()), f"flash_attention_bwd {site} {name}: non-finite")
        readings[name] = own_ulps(torch, kk, r, floors[name])
        bad = kk.float().clone()
        bad[0, 0, 0] += max(rms(r), floors[name])
        planted[name] = own_ulps(torch, bad, r, floors[name])
    bias_desc = "none" if bias is None else list(bias.shape)
    print(f"parity flash_attention_bwd {site} B={b} H={HEADS} Sq={sq} Skv={skv} bias={bias_desc}: "
          + ", ".join(f"{n} {readings[n]:.3g} own ulps (planted {planted[n]:.3g})" for n in readings)
          + f", limit {FLASH_BWD_LIMIT}; rel norm " + " ".join(
              f"{n} {rel_norm(kk, r):.2e}" for n, kk, r in zip(readings, got, want)))
    for n in readings:
        check(readings[n] <= FLASH_BWD_LIMIT < planted[n],
              f"flash_attention_bwd {site} {n} disagrees with the plain version: {readings[n]} "
              f"(limit {FLASH_BWD_LIMIT}, planted {planted[n]})")
    stable = all(torch.equal(a, c) for a, c in zip(got, again))
    print(f"parity flash_attention_bwd {site}: second call bitwise equal: {stable}")
    check(stable, f"flash_attention_bwd {site} is not bitwise stable across two calls")
    return {n: (kk.float() - r.float()).abs().max().item() for n, kk, r in zip(readings, got, want)}


def flash_bwd_probes(torch):
    """p and ds stay fp32 in their products.  Each probe puts two terms that
    are equal in bf16 but not in fp32 (1 + 2^-10 and 1, or e^(-2^-10) and 1)
    on operands +1000 and -1000, so the gradient is ~1000 * 2^-10 with fp32
    terms and exactly 0 with terms rounded to bf16.  The logits come from the
    [1, 1, Sq, Skv] bias (q.k^T = 0), the forward's o from the caller (it only
    feeds delta = rowsum(dO o)).
    #8 ds: keys k0 = +1000 e0, k1 = -1000 e0, k2 = 0, bias (ln 2, 0, 0) -> p =
      (1/2, 1/4, 1/4); dO = e0 + e1, v0 = (10, 2^-9), v1 = (12, 0), v2 = 0 and
      o = (8, 0) -> delta = 8, ds = (1 + 2^-10, 1, -2): dq = 1000 * 2^-10 * scale.
    #9 ds: q_a = +1000 e0, q_b = -1000 e0, keys 0; two keys at p = 1/2; dO_a =
      (4, 2^-8), dO_b = (4, 0), v0 = e0 + e1, v1 = 0, o = v0 / 2 -> ds_a0 = 1 +
      2^-10, ds_b0 = 1: dk0 = 1000 * 2^-10 * scale.
    #9 p: row a's logits (0, ln(e^(2^-10) - 1)), row b's (0, -10^4) -> p_a0 =
      e^(-2^-10), p_b0 = 1; dO_a = +1000 e0, dO_b = -1000 e0: dv0 = 1000 (e^(-2^-10) - 1)."""
    from feddat_tpu_torch.ops import flash as fl

    def zeros(s):
        return torch.zeros(1, 1, s, 64, dtype=torch.bfloat16, device="cuda")

    def run(q, k, v, o, do, bias, scale=0.125):
        with torch.no_grad():
            _, lse = fl.flash_attention_fwd_cuda(q, k, v, bias, scale)
            got = fl.flash_attention_bwd_cuda(q, k, v, bias, o, do, lse, scale)
            want = fl.flash_attention_bwd_ref(q, k, v, bias, o, do, lse, scale)
        torch.cuda.synchronize()
        return got, want

    # #8: ds in ds.k
    q, k, v, o, do = zeros(1), zeros(3), zeros(3), zeros(1), zeros(1)
    k[0, 0, 0, 0], k[0, 0, 1, 0] = 1000.0, -1000.0
    v[0, 0, 0, 0], v[0, 0, 0, 1], v[0, 0, 1, 0] = 10.0, 2.0 ** -9, 12.0
    o[0, 0, 0, 0] = 8.0
    do[0, 0, 0, :2] = 1.0
    bias = torch.tensor([math.log(2.0), 0.0, 0.0], device="cuda").view(1, 1, 1, 3)
    (dq, _, _), (dq_r, _, _) = run(q, k, v, o, do, bias)
    results = {"#8 ds": (dq[0, 0, 0, 0].item(), dq_r[0, 0, 0, 0].item(), 1000 * 2.0 ** -10 * 0.125)}

    # #9: ds in ds^T.q, and p in p^T.dO
    q, k, v, o, do = zeros(2), zeros(2), zeros(2), zeros(2), zeros(2)
    q[0, 0, 0, 0], q[0, 0, 1, 0] = 1000.0, -1000.0
    v[0, 0, 0, :2] = 1.0
    o[0, 0, :, :2] = 0.5
    do[0, 0, 0, 0], do[0, 0, 0, 1], do[0, 0, 1, 0] = 4.0, 2.0 ** -8, 4.0
    (_, dk, _), (_, dk_r, _) = run(q, k, v, o, do, torch.zeros(1, 1, 1, 2, device="cuda"))
    results["#9 ds"] = (dk[0, 0, 0, 0].item(), dk_r[0, 0, 0, 0].item(), 1000 * 2.0 ** -10 * 0.125)
    q, o = zeros(2), zeros(2)
    do = zeros(2)
    do[0, 0, 0, 0], do[0, 0, 1, 0] = 1000.0, -1000.0
    bias = torch.tensor([[0.0, math.log(math.expm1(2.0 ** -10))], [0.0, -1e4]],
                        device="cuda").view(1, 1, 2, 2)
    (_, _, dv), (_, _, dv_r) = run(q, k, v, o, do, bias)
    results["#9 p"] = (dv[0, 0, 0, 0].item(), dv_r[0, 0, 0, 0].item(), 1000 * math.expm1(-2.0 ** -10))
    print("parity flash_attention_bwd probes (kernel, plain version, exact; terms rounded to bf16 "
          "give 0): " + "; ".join(f"{n} {a:.6f} {b:.6f} {e:.6f}" for n, (a, b, e) in results.items()))
    for name, (got, plain, exact) in results.items():
        check(abs(got - exact) <= 2 * bf16_ulp(abs(exact)) and abs(plain - exact) <= 2 * bf16_ulp(abs(exact)),
              f"flash_attention_bwd {name}: rounded below fp32 ({got} vs {exact})")


# ALBEF's ViT length (S=577, B=2, no padding bias: the tuned configuration's
# ViT, LN1 outside #1 and #3 past 448) and the edges around it: 592 (#1's
# logits tile pads 577 to 592), 593 (one row more: 608) and 768 (the longest
# S a block's fp32 logits tile holds), B=1 with a padding bias.
VIT_LENGTH_CASES = ((2, VIT_S, False), (1, 592, True), (1, 593, True), (1, 768, True))
# Past the 768 keys that #1's first attention core held as fp32 logits in
# shared memory: (B, S) of #1 and #3 (LN1 fused and outside) and #4 (both
# adapter modes), with a padding bias.
LONG_CASES = ((2, 769), (1, 1024))


def vit_length_parity(torch, seed):
    """#1 (LN1 outside, as the model runs it past LN_FUSED_MAX_S), #3 (LN1
    outside) and #4 (both adapter modes at S=577) at :data:`VIT_LENGTH_CASES`,
    then at the albef_tuned phase's own shapes, without a padding bias: #1
    and #4 (both adapter modes) at the tuned step's B=ATB, where #4's adapter
    weight gradients sum M = B*S = 27 696 rows in partial-sum chunks, and #3
    at the "block" path's B=SECOND_B; under the limits of the other cases."""
    for b, s, masked in VIT_LENGTH_CASES:
        attn_parity(torch, b, s, False, seed + s, masked)
        attn_bwd_parity(torch, b, s, False, seed + s, masked)
        for use_b in ((True, False) if s == VIT_S else (s % 2 == 0,)):
            layer_bwd_parity(torch, b, s, use_b, seed + s, masked)
    attn_parity(torch, ATB, VIT_S, False, seed + 1, masked=False)
    for use_b in (True, False):
        layer_bwd_parity(torch, ATB, VIT_S, use_b, seed + 1, masked=False)
    attn_bwd_parity(torch, SECOND_B, VIT_S, False, seed + 1, masked=False)


def long_length_parity(torch, seed):
    """#1, #3 and #4 at :data:`LONG_CASES`, under the limits of the other
    cases."""
    for b, s in LONG_CASES:
        for ln in (True, False):
            attn_parity(torch, b, s, ln, seed + s)
            attn_bwd_parity(torch, b, s, ln, seed + s)
        for use_b in (True, False):
            layer_bwd_parity(torch, b, s, use_b, seed + s)


def phase_parity(torch, seed, root):
    errs = {"attn_block": attn_parity(torch, B, S, True, seed)}
    for b, s, ln in ((TB, TS, True), (3, 21, True), (3, 17, False), (3, 21, False), (2, 130, True)):
        attn_parity(torch, b, s, ln, seed + s)
    for s in EDGE_LENGTHS:  # M = S rows: the edges of the GEMM's 128-row tiles
        for flag in (True, False):
            attn_parity(torch, 1, s, flag, seed + s)
    attn_parity(torch, *STUDY_SHAPE, True, seed + 77)  # the study's step (phase 17)
    errs["adapter_fused"] = adapter_parity(torch, B * S, seed)
    for r in ADAPTER_BOTTLENECKS:
        for n in ADAPTER_ROWS:
            adapter_parity(torch, n, seed + n + r, r)
    adapter_probe(torch)
    for r, d in ADAPTER_WIDE:
        for n in ADAPTER_WIDE_ROWS:
            adapter_parity(torch, n, seed + n + r + d, r, d)
    adapter_probe(torch, 192, (150, 151))  # b's units in the second chunk of 96
    errs["attn_block_bwd"] = max(attn_bwd_parity(torch, TB, TS, ln, seed) for ln in (True, False))
    for b, s, ln in ((3, 17, True), (3, 21, False), (2, 130, True), (1, 450, True)):
        attn_bwd_parity(torch, b, s, ln, seed + s)
    for s in EDGE_LENGTHS:  # M = S rows: the edges of the 128-row tiles of the GEMMs
        for flag in (True, False):
            attn_bwd_parity(torch, 1, s, flag, seed + s)
    attn_bwd_parity(torch, *STUDY_SHAPE, True, seed + 77)
    errs["layer_block_bwd"] = max(layer_bwd_parity(torch, TB, TS, e, seed) for e in (True, False))
    for b, s, e in ((3, 17, True), (3, 21, False), (2, 130, True), (2, 281, False), (1, 450, True)):
        layer_bwd_parity(torch, b, s, e, seed + s)
    for s in EDGE_LENGTHS:
        for flag in (True, False):
            layer_bwd_parity(torch, 1, s, flag, seed + s)
    layer_bwd_parity(torch, *STUDY_SHAPE, True, seed + 77)  # the study on "layer"
    vit_length_parity(torch, seed)
    long_length_parity(torch, seed)
    errs["fused_attention"], errs["fused_attention_bwd"] = fused_parity(torch, TB, TS, seed)
    fused_parity(torch, B, S, seed + 1)  # the serving canvas, keys dropped by the padding mask
    fused_parity(torch, 3, 295, seed + 2)  # the longest S the JAX gate admits at 12 heads
    fused_parity(torch, 4, TS + 10, seed + 3, batch1=True, layout="contiguous")
    fused_parity(torch, 2, 37, seed + 4)
    for s in FUSED_EDGE_LENGTHS:  # the edges of the kernels' 64-row tiles
        fused_parity(torch, 1, s, seed + s)
    for s in (769, 1024):  # past the 768 keys that a logits tile in shared memory allowed
        fused_parity(torch, 1, s, seed + s)
    fused_parity(torch, 2, TS, seed + 5, mask_all=True)
    fused_probes(torch)
    flash_errs = {site: flash_parity(torch, site, b, sq, skv, kind, seed + i)
                  for i, (site, b, sq, skv, kind) in enumerate(FLASH_CASES)}
    errs["flash_attention"] = flash_errs["vit"]
    flash_p_probe(torch)
    bwd_errs = {site: flash_bwd_parity(torch, site, b, sq, skv, kind, seed + 20 + i)
                for i, (site, b, sq, skv, kind) in enumerate(FLASH_BWD_CASES)}
    errs["flash_attention_bwd_dq"] = bwd_errs["vit self"]["dq"]
    errs["flash_attention_bwd_dkv"] = max(bwd_errs["vit self"]["dk"], bwd_errs["vit self"]["dv"])
    flash_bwd_probes(torch)
    flash_refusals(torch)
    disk_parity(torch, root, seed)
    return errs


def synthetic_requests(n, seed):
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    sizes = [(480, 640), (640, 427), (375, 500), (300, 300), (512, 768), (240, 320)]
    imgs = [Image.fromarray(rng.randint(0, 256, (*sizes[i % len(sizes)], 3), dtype=np.uint8))
            for i in range(n)]
    words = ["what", "color", "is", "the", "cat", "on", "left", "how", "many", "people", "are",
             "there", "in", "picture", "does", "this", "man", "have", "a", "hat"]
    qs = [" ".join(rng.choice(words, size=rng.randint(4, 12))) + "?" for _ in range(n)]
    return imgs, qs


def build_predictor(torch, seed, attn_impl, fused, state=None, canvas=CANVAS, reduction=16,
                    dtype="bfloat16"):
    from feddat_tpu_torch.configs.core import PEFTMode
    from feddat_tpu_torch.data.tokenizer import WordPieceTokenizer
    from feddat_tpu_torch.models import create_model
    from feddat_tpu_torch.models.vilt import TaskHeadSpec
    from feddat_tpu_torch.serving import ViltVqaPredictor

    model, cfg = create_model(
        "vilt", {"vqa": TaskHeadSpec(num_labels=NUM_LABELS)}, PEFTMode.DAT, reduction, dtype,
        image_size=canvas, attn_impl=attn_impl, adapter_fused=fused, seed=seed,
    )
    check(cfg.fuse_ln and cfg.adapter.fused == fused, f"unexpected model config {cfg}")
    tok = WordPieceTokenizer.from_vocab_file(str(REPO / "tests" / "fixtures" / "vocab30k.txt"))
    return ViltVqaPredictor(
        model, state, "vqa", tok, [f"answer_{i}" for i in range(NUM_LABELS)], batch_size=B,
        canvas=canvas, max_text_len=TEXT_LEN, adapter_mode="ensemble", batch_buckets=(1,),
    )


def phase_serve(torch, seed):
    from feddat_tpu_torch.ops import adapter_fused as af
    from feddat_tpu_torch.ops import attn_block as ab

    pred = build_predictor(torch, seed, "block", True)
    imgs, qs = synthetic_requests(B, seed)
    layers = pred.model.config.num_layers
    ab.KERNEL.launches = af.KERNEL.launches = 0
    batch_out = pred.predict(imgs, qs, top_k=5)
    single_out = pred.predict(imgs[:1], qs[:1], top_k=5)
    torch.cuda.synchronize()
    launches = {"attn_block": ab.KERNEL.launches, "adapter_fused": af.KERNEL.launches}
    print(f"serve: main path launches over 2 forwards x {layers} layers: {launches}")
    for name, n in launches.items():
        check(n == 2 * layers, f"{name} launched {n} times, expected {2 * layers}")
    check(len(batch_out) == B and all(len(r) == 5 for r in batch_out), "bad batch result shape")
    check(len(single_out) == 1, "bad single result shape")
    for row in batch_out + single_out:
        probs = [p for _, p in row]
        check(all(math.isfinite(p) and 0.0 <= p <= 1.0 for p in probs), f"bad probabilities {row}")
        check(probs == sorted(probs, reverse=True), "top-k not in descending order")

    batch, n = pred._preprocess(imgs, qs), B
    probs_kernel = pred.forward(batch)
    plain = build_predictor(torch, seed, "auto", False, state=pred.model.state_dict())
    before = (ab.KERNEL.launches, af.KERNEL.launches)
    probs_plain = plain.forward(batch)
    check((ab.KERNEL.launches, af.KERNEL.launches) == before, "the plain path launched a kernel")
    serving_agreement("serve:", probs_kernel, probs_plain, n)
    singles = pred.predict(imgs[:1], qs[:1], top_k=5)
    check([a for a, _ in singles[0]] == [a for a, _ in single_out[0]], "single request not stable")
    return pred, plain, launches, (imgs, qs, batch)


def serving_agreement(tag, probs_kernel, probs_plain, n):
    """The serving rule: kernel path probabilities within 5% of the plain
    path's largest, each row a distribution."""
    check(probs_kernel.shape == (n, NUM_LABELS), f"probs shape {probs_kernel.shape}")
    sums = probs_kernel.sum(-1)
    check(bool(abs(sums - 1.0).max() < 1e-3), f"probabilities do not sum to 1: {sums}")
    diff = float(abs(probs_kernel - probs_plain).max())
    top = float(probs_plain.max())
    # bf16 rounding happens at other places on the two paths (kernel vs
    # cuBLAS accumulation order, fused vs unfused LN and adapter mix) and
    # compounds over 12 layers: allow 5% of the largest probability.
    tol = 0.05 * top
    agree = int((probs_kernel.argmax(-1) == probs_plain.argmax(-1)).sum())
    print(f"{tag} kernel path vs plain path probabilities max_abs_diff={diff:.3e} tol={tol:.3e} "
          f"(5% of max prob {top:.3e}); top-1 agreement {agree}/{n}")
    check(diff <= tol, f"{tag} kernel path disagrees with the plain path: {diff} > {tol}")


def counters():
    from feddat_tpu_torch.ops import adapter_fused as af
    from feddat_tpu_torch.ops import attn_block as ab
    from feddat_tpu_torch.ops import flash as fl
    from feddat_tpu_torch.ops import fused_attention as fa
    from feddat_tpu_torch.ops import layer_block as lb

    return {"attn_block": ab.KERNEL, "adapter_fused": af.KERNEL,
            "attn_block_bwd": ab.KERNEL_BWD, "layer_block_bwd": lb.KERNEL,
            "fused_attention": fa.KERNEL, "fused_attention_bwd": fa.KERNEL_BWD,
            "flash_attention": fl.KERNEL, "flash_attention_bwd_dq": fl.KERNEL_BWD_DQ,
            "flash_attention_bwd_dkv": fl.KERNEL_BWD_DKV}


def reset_counts():
    for k in counters().values():
        k.launches = 0


def read_counts():
    return {name: k.launches for name, k in counters().items()}


NO_LAUNCHES = {"attn_block": 0, "adapter_fused": 0, "attn_block_bwd": 0, "layer_block_bwd": 0,
               "fused_attention": 0, "fused_attention_bwd": 0, "flash_attention": 0,
               "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0}


TRAIN_CLIENTS = ("c0", "c1")


def build_trainer_model(torch, seed, attn_impl, state=None, dtype="bfloat16", fused=False):
    from feddat_tpu_torch.configs.core import PEFTMode
    from feddat_tpu_torch.models import create_model
    from feddat_tpu_torch.models.vilt import TaskHeadSpec

    model, cfg = create_model(
        "vilt", {k: TaskHeadSpec(num_labels=NUM_LABELS) for k in TRAIN_CLIENTS}, PEFTMode.DAT, 16,
        dtype, image_size=TCANVAS, attn_impl=attn_impl, adapter_fused=fused,
        seed=seed if state is None else None)
    check(cfg.fuse_ln and cfg.adapter.fused == fused and cfg.hidden_dropout == 0.0, f"unexpected {cfg}")
    if state is not None:
        model.load_state_dict(state)
    return model


def train_client(key, num_train, num_eval, seed):
    from feddat_tpu_torch.data.synthetic import SyntheticVQAClient

    return SyntheticVQAClient(key, num_train=num_train, num_eval=num_eval, num_labels=NUM_LABELS,
                              vocab_size=30522, text_len=TEXT_LEN, image_size=TCANVAS,
                              batch_size=TB, val_batch_size=TB, seed=seed)


def make_steps(model, params, fused=True):
    from feddat_tpu_torch.configs.core import OptimizerConfig, PEFTMode
    from feddat_tpu_torch.train import dat
    from feddat_tpu_torch.train.forwards import make_vilt_forward, make_vilt_fused_parts

    part = dat.Partitioner(params, TRAIN_CLIENTS[0], PEFTMode.DAT)
    opt = OptimizerConfig()
    if fused:
        step = dat.make_dat_train_step_fused(*make_vilt_fused_parts(model, TRAIN_CLIENTS[0]), part,
                                             opt, 100)
    else:
        step = dat.make_dat_train_step(make_vilt_forward(model, TRAIN_CLIENTS[0]), part, opt, 100)
    return step, part, opt


def set_error(torch, got, exact):
    """Relative Frobenius error of one gradient set (all its tensors as one
    vector) and the worst single tensor's."""
    num = den = 0.0
    worst, worst_name = 0.0, ""
    for name, e in exact.items():
        g, e = got[name].float(), e.float()
        check(bool(torch.isfinite(g).all()), f"non-finite gradient {name}")
        d2, e2 = (g - e).pow(2).sum().item(), e.pow(2).sum().item()
        num, den = num + d2, den + e2
        if (d2 / max(e2, 1e-60)) ** 0.5 > worst:
            worst, worst_name = (d2 / max(e2, 1e-60)) ** 0.5, name
    return (num / max(den, 1e-60)) ** 0.5, worst, worst_name


# Kernel path vs plain path over one full-width train step.  Both paths compute
# in bf16 and round at other places (the layer route keeps p1 in fp32 and takes
# GELU' from the polynomial erf; the plain path rounds every Dense output to
# bf16 as flax does); the adapters' ReLU gates flip where they differ near 0,
# and it compounds over 12 layers.  With random weights the adapter-down
# gradients are small and bf16 noise is a visible share of some of them (the
# phase prints the plain bf16 path's own worst tensor, ~3% from fp32 at B=64).
# So both bf16 paths are held against the plain path in fp32 (attn_impl='auto',
# float32, the exact function): per gradient set (the two updates' adapter and
# head gradients), the kernel path's relative Frobenius error may be at most
# twice the plain bf16 path's, or 1%; the losses within 1% of the fp32 ones.
TRAIN_GRAD_FACTOR, TRAIN_GRAD_FLOOR = 2.0, 1e-2
TRAIN_LOSS_TOL = 1e-2


def grad_agreement(torch, what, kernel, plain_bf16, exact, loss_keys=("loss", "loss_shared")):
    worst_ratio = 0.0
    for stage in exact["grads"]:
        k, kw, kn = set_error(torch, kernel["grads"][stage], exact["grads"][stage])
        p, pw, _ = set_error(torch, plain_bf16["grads"][stage], exact["grads"][stage])
        tol = max(TRAIN_GRAD_FACTOR * p, TRAIN_GRAD_FLOOR)
        print(f"train: {what} {stage} gradients vs plain fp32: kernel path {k:.3e} (worst tensor "
              f"{kw:.3e} {kn}), plain bf16 path {p:.3e} (worst tensor {pw:.3e}); tol {tol:.3e}")
        check(k <= tol, f"{what}: {stage} gradients disagree: {k} > {tol}")
        worst_ratio = max(worst_ratio, k / tol)
    for key in loss_keys:
        k, e = float(kernel[key]), float(exact[key])
        print(f"train: {what} {key}: kernel path {k:.6f}, plain bf16 {float(plain_bf16[key]):.6f}, "
              f"plain fp32 {e:.6f}")
        check(abs(k - e) <= TRAIN_LOSS_TOL * abs(e), f"{what}: {key} disagrees: {k} vs {e}")
    return worst_ratio


def phase_train(torch, seed):
    from feddat_tpu_torch.configs.core import FederatedConfig, OptimizerConfig, PEFTMode, TrainConfig
    from feddat_tpu_torch.federated.engine import FederatedTrainer
    from feddat_tpu_torch.train import dat
    from feddat_tpu_torch.train.forwards import to_device

    model = build_trainer_model(torch, seed, "layer")
    layers = model.config.num_layers
    params = {k: v.detach() for k, v in model.state_dict().items()}
    batch = to_device(next(train_client(TRAIN_CLIENTS[0], TB, 0, seed).train_batches(0)), "cuda")
    step, part, opt = make_steps(model, params)
    state0 = dat.init_train_state(params, part, opt, torch.Generator().manual_seed(seed))
    torch.cuda.synchronize()
    reset_counts()
    state, m = step(state0, batch)
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"train: fused DAT step, attn_impl='layer', B={TB} S={TS}: launches {launches}")
    want = {**NO_LAUNCHES, "attn_block": 2 * layers, "layer_block_bwd": 2 * layers}
    check(launches == want, f"fused step launches {launches}, expected {want}")
    losses = [(float(m["loss"]), float(m["loss_shared"]))]
    for _ in range(2):
        state, mm = step(state, batch)
        losses.append((float(mm["loss"]), float(mm["loss_shared"])))
    print(f"train: fused DAT steps (loss, loss_shared): {[tuple(round(v, 4) for v in l) for l in losses]}")
    check(all(math.isfinite(v) for l in losses for v in l), "non-finite train loss")

    plain_model = build_trainer_model(torch, seed, "auto", model.state_dict())
    exact_model = build_trainer_model(torch, seed, "auto", model.state_dict(), "float32")
    before = read_counts()
    plain = {fused: make_steps(plain_model, params, fused)[0](state0, batch)[1]
             for fused in (True, False)}
    exact = {fused: make_steps(exact_model, params, fused)[0](state0, batch)[1]
             for fused in (True, False)}
    torch.cuda.synchronize()
    check(read_counts() == before, "the plain path launched a kernel")
    del exact_model
    fused_err = grad_agreement(torch, "fused step, layer kernels", m, plain[True], exact[True])

    block_model = build_trainer_model(torch, seed, "block", model.state_dict())
    std_step, _, _ = make_steps(block_model, params, fused=False)
    reset_counts()
    _, bm = std_step(state0, batch)
    torch.cuda.synchronize()
    std_launches = read_counts()
    # layer 0's attention input depends on no trainable parameter, so autograd
    # (like JAX's vjp) never asks for its backward: #3 runs for layers 1..L-1
    want = {**NO_LAUNCHES, "attn_block": 3 * layers, "attn_block_bwd": 2 * (layers - 1)}
    print(f"train: standard DAT step, attn_impl='block': launches {std_launches}")
    check(std_launches == want, f"standard step launches {std_launches}, expected {want}")
    std_err = grad_agreement(torch, "standard step, block kernels", bm, plain[False], exact[False])
    del m, bm, plain, exact

    clients = {k: train_client(k, 2 * TB, TB, seed + 1 + i) for i, k in enumerate(TRAIN_CLIENTS)}
    cfg = TrainConfig(peft_mode=PEFTMode.DAT, optimizer=OptimizerConfig(),
                      federated=FederatedConfig(comm_rounds=1, local_epochs=1, eval_every=1),
                      num_epochs=1, seed=seed)
    trainer = FederatedTrainer(model, params, clients, cfg, use_fused_dat=True)
    t0 = time.perf_counter()
    reset_counts()
    trainer.run_round(0)
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    round_launches = read_counts()
    entry = trainer.evaluate_round(0)
    torch.cuda.synchronize()
    print(f"train: FederatedTrainer round of {len(clients)} clients x 2 fused steps in "
          f"{round_s:.2f} s, launches {round_launches}; evaluate_dat {entry['scores']}")
    check(round_launches["layer_block_bwd"] == 2 * 2 * len(clients) * layers,
          f"round launches {round_launches}")
    for key, scores in entry["scores"].items():
        check(len(scores) == 3 and all(math.isfinite(v) and 0.0 <= v <= 100.0 for v in scores),
              f"bad evaluate_dat scores for {key}: {scores}")
    moved = [k for k, v in trainer.server_params.items() if "adapter_1" in k and not torch.equal(v, params[k])]
    check(len(moved) == 4 * layers and all(bool(torch.isfinite(trainer.server_params[k]).all()) for k in moved),
          "FedAvg did not update every adapter_1 tensor on the server")
    personal = [trainer.personal[k]["vilt.layers.0.adapter.adapter_0_up.bias"] for k in TRAIN_CLIENTS]
    check(not torch.equal(*personal), "the clients' personal adapter_0 were averaged")
    return dict(model=model, plain_model=plain_model, block_model=block_model, params=params,
                batch=batch, state0=state0, launches=launches, std_launches=std_launches,
                grad_errs=(fused_err, std_err))


# The single-update PEFT baselines through attn_impl="fused" (the grid of
# scripts/peft_bench.py plus full and freeze_bottom_k): a 100-label head,
# LoRA r=16, alpha 1 on q/v, 5+5 prompts (S=195), the bottom 2 layers frozen.
PEFT_MODES = ("lora", "bias", "full", "prompt", "freeze_bottom_k_layers")
PEFT_LABELS = 100
FREEZE_K = 2


def peft_model(torch, mode, seed, attn_impl, dtype="bfloat16", logits="float32", state=None):
    from feddat_tpu_torch.configs.core import PEFTMode
    from feddat_tpu_torch.models import create_model
    from feddat_tpu_torch.models.vilt import TaskHeadSpec

    model, cfg = create_model(
        "vilt", {k: TaskHeadSpec(num_labels=PEFT_LABELS) for k in TRAIN_CLIENTS}, PEFTMode(mode), 16,
        dtype, image_size=TCANVAS, attn_impl=attn_impl, attention_logits_dtype=logits,
        seed=seed if state is None else None)
    check(cfg.lora.enabled == (mode == "lora") and cfg.prompt.enabled == (mode == "prompt")
          and cfg.lora.rank == 16 and cfg.lora.alpha == 1.0, f"unexpected {cfg}")
    if state is not None:
        model.load_state_dict(state)
    elif mode == "lora":
        # lora_b's JAX init is zeros, which makes lora_a's first gradient exactly
        # 0: draw it at the projections' std so both factors are checked
        g = torch.Generator(device="cuda").manual_seed(seed + 7)
        with torch.no_grad():
            for name, prm in model.named_parameters():
                if "lora_b" in name:
                    prm.copy_(torch.randn(prm.shape, generator=g, device="cuda") * 0.02)
    return model


def peft_client(key, num_train, num_eval, seed):
    from feddat_tpu_torch.data.synthetic import SyntheticVQAClient

    return SyntheticVQAClient(key, num_train=num_train, num_eval=num_eval, num_labels=PEFT_LABELS,
                              vocab_size=30522, text_len=TEXT_LEN, image_size=TCANVAS,
                              batch_size=TB, val_batch_size=TB, seed=seed)


def peft_step(model, mode, params, adapter_mode="none"):
    from feddat_tpu_torch.configs.core import OptimizerConfig, PEFTMode
    from feddat_tpu_torch.train import dat
    from feddat_tpu_torch.train.forwards import make_vilt_forward

    part = dat.Partitioner(params, TRAIN_CLIENTS[0], PEFTMode(mode), layers_to_freeze=FREEZE_K)
    opt = OptimizerConfig()
    step = dat.make_plain_train_step(make_vilt_forward(model, TRAIN_CLIENTS[0]), part, opt, 100,
                                     adapter_mode)
    return step, part, opt


def peft_grads(torch, model, params, part, batch, adapter_mode="none"):
    """The plain step's loss and gradients of its trainable set (what its
    AdamW update consumes), on ``model``'s attention route and dtype."""
    from feddat_tpu_torch.train.forwards import make_vilt_forward

    leaves = {n: params[n].detach().requires_grad_() for n in sorted(part.shared_paths | part.head_paths)}
    loss, _ = make_vilt_forward(model, TRAIN_CLIENTS[0])({**params, **leaves}, batch, adapter_mode)
    return {"loss": loss.detach(), "grads": {"trainable": dict(zip(
        leaves, torch.autograd.grad(loss, list(leaves.values()))))}}


def phase_peft(torch, seed):
    """Each PEFT mode's plain train step at full width through attn_impl="fused":
    #5/#6 launches of one step, gradients held to the 2x-bf16 rule; then one
    FederatedTrainer round of LoRA and its evaluation."""
    from feddat_tpu_torch.configs.core import FederatedConfig, OptimizerConfig, PEFTMode, TrainConfig
    from feddat_tpu_torch.federated.engine import FederatedTrainer
    from feddat_tpu_torch.train import dat
    from feddat_tpu_torch.train.forwards import to_device

    batch = to_device(next(peft_client(TRAIN_CLIENTS[0], TB, 0, seed).train_batches(0)), "cuda")
    out = {"grad_ratio": {}}
    for mode in PEFT_MODES:
        model = peft_model(torch, mode, seed, "fused")
        layers = model.config.num_layers
        params = {k: v.detach() for k, v in model.state_dict().items()}
        step, part, opt = peft_step(model, mode, params)
        state0 = dat.init_train_state(params, part, opt, torch.Generator().manual_seed(seed))
        seq = TS + (2 * model.config.prompt.length if mode == "prompt" else 0)
        torch.cuda.synchronize()
        reset_counts()
        _, m = step(state0, batch)
        torch.cuda.synchronize()
        launches = read_counts()
        trained = layers - FREEZE_K if mode == "freeze_bottom_k_layers" else layers
        want = {**NO_LAUNCHES, "fused_attention": layers, "fused_attention_bwd": trained}
        print(f"peft: {mode} step, attn_impl='fused', B={TB} S={seq}: #5/#6 launches "
              f"{launches['fused_attention']}/{launches['fused_attention_bwd']} (expected "
              f"{layers}/{trained}), loss {float(m['loss']):.4f}")
        check(launches == want, f"{mode} step launches {launches}, expected {want}")
        check(math.isfinite(float(m["loss"])), f"{mode}: non-finite loss")

        sd = model.state_dict()
        kernel = peft_grads(torch, model, params, part, batch)
        before = read_counts()
        plain = peft_grads(torch, peft_model(torch, mode, seed, "auto", state=sd), params, part, batch)
        exact = peft_grads(torch, peft_model(torch, mode, seed, "auto", "float32", state=sd), params,
                           part, batch)
        torch.cuda.synchronize()
        check(read_counts() == before, "the plain path launched a kernel")
        out["grad_ratio"][mode] = grad_agreement(torch, f"peft {mode}", kernel, plain, exact,
                                                 ("loss",))
        del kernel, plain, exact
        if mode == "lora":
            out.update(model=model, params=params, state0=state0, batch=batch, launches=launches)
        else:
            del model, params, state0, sd
        torch.cuda.empty_cache()

    model, params = out["model"], out["params"]
    layers = model.config.num_layers
    clients = {k: peft_client(k, 2 * TB, TB, seed + 1 + i) for i, k in enumerate(TRAIN_CLIENTS)}
    cfg = TrainConfig(peft_mode=PEFTMode.LORA, optimizer=OptimizerConfig(),
                      federated=FederatedConfig(comm_rounds=1, local_epochs=1, eval_every=1),
                      num_epochs=1, seed=seed, layers_to_freeze=FREEZE_K)
    trainer = FederatedTrainer(model, params, clients, cfg)
    reset_counts()
    t0 = time.perf_counter()
    trainer.run_round(0)
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    round_launches = read_counts()
    reset_counts()
    entry = trainer.evaluate_round(0)
    torch.cuda.synchronize()
    eval_launches = read_counts()
    steps = 2 * len(clients)
    print(f"peft: FederatedTrainer LoRA round of {len(clients)} clients x 2 steps in {round_s:.2f} s, "
          f"#5/#6 launches {round_launches['fused_attention']}/{round_launches['fused_attention_bwd']}; "
          f"evaluate {entry['scores']}, #5/#6 launches {eval_launches['fused_attention']}/"
          f"{eval_launches['fused_attention_bwd']}")
    check(round_launches == {**NO_LAUNCHES, "fused_attention": steps * layers,
                             "fused_attention_bwd": steps * layers}, f"round launches {round_launches}")
    check(eval_launches == {**NO_LAUNCHES, "fused_attention": len(clients) * layers},
          f"evaluate launches {eval_launches}")
    for key, score in entry["scores"].items():
        check(math.isfinite(score) and 0.0 <= score <= 100.0, f"bad evaluate score for {key}: {score}")
    moved = [k for k, v in trainer.server_params.items() if "lora_" in k and not torch.equal(v, params[k])]
    others = [k for k, v in trainer.server_params.items()
              if "lora_" not in k and "task_" not in k and not torch.equal(v, params[k])]
    check(len(moved) == 4 * layers and not others
          and all(bool(torch.isfinite(trainer.server_params[k]).all()) for k in moved),
          f"FedAvg moved {len(moved)} LoRA tensors (expected {4 * layers}) and {len(others)} others")
    out["round_s"] = round_s
    return out


def albef_predictor(torch, seed, attn_impl, dtype="bfloat16"):
    """Full-width ALBEF DAT (random weights from ``seed``) behind the predictor."""
    from feddat_tpu_torch.configs.core import PEFTMode
    from feddat_tpu_torch.data.tokenizer import WordPieceTokenizer
    from feddat_tpu_torch.models import create_model
    from feddat_tpu_torch.serving import AlbefVqaPredictor

    model, cfg = create_model("albef_no_distill", {}, PEFTMode.DAT, 16, dtype, attn_impl=attn_impl,
                              seed=seed)
    check(cfg.adapter.names == ("adapter_0", "adapter_1", "adapter_2") and cfg.adapter.reduction_factor == 16
          and cfg.eval_pack_group == PACK and cfg.image_res == ARES and cfg.bert.vocab_size == 30522
          and (cfg.bert.fusion_layer, cfg.bert.num_layers, cfg.decoder_layers) == (6, 12, 6),
          f"unexpected ALBEF config {cfg}")
    tok = WordPieceTokenizer.from_vocab_file(str(REPO / "tests" / "fixtures" / "vocab30k.txt"))
    return AlbefVqaPredictor(model, None, tok, ALBEF_ANSWERS, batch_size=AB, k=ALBEF_K,
                             max_question_len=LQ, max_answer_len=LA, adapter_mode="ensemble",
                             batch_buckets=(1,))


def albef_requests(n, seed):
    imgs, _ = synthetic_requests(n, seed)
    import numpy as np

    rng = np.random.RandomState(seed + 1)
    words = ["what", "color", "is", "the", "dog", "how", "many", "people", "are", "there", "in",
             "this", "picture", "sport", "being", "played", "which", "side", "of", "plate", "room"]
    qs = ["what " + " ".join(rng.choice(words, size=rng.randint(3, 20))) + "?" for _ in range(n)]
    return imgs, qs


# Kernel path vs plain path on ALBEF's rank_answer.  Both bf16 paths are held
# against the plain path in fp32 (the exact function) by relative Frobenius
# error: the question states and the stage-1 logits of the kernel path may be
# at most twice as far from fp32 as the plain bf16 path's, or 1%.  A top-1
# answer may differ from the fp32 path's only where the fp32 path's top two
# reranked probabilities are within that tolerance of each other.
ALBEF_FACTOR, ALBEF_FLOOR = 2.0, 1e-2


def albef_stages(torch, pred, t):
    """(question states [B, Lq, D], stage-1 logits [B, V]) of one predictor."""
    m = pred.model
    with torch.inference_mode():
        qs = m.encode_question(t["pixel_values"], t["question_ids"], t["question_mask"], "ensemble")
        bos = pred.bank[0][0, 0].expand(qs.shape[0], 1)
        ones = torch.ones_like(bos, dtype=torch.int32)
        logits = m.decode_logits(bos, ones, qs, t["question_mask"], "ensemble")[:, 0]
    return qs.float(), logits.float()


def phase_albef(torch, seed):
    import numpy as np

    pred = albef_predictor(torch, seed, "flash")
    imgs, qs = albef_requests(AB, seed)
    torch.cuda.synchronize()
    reset_counts()
    batch_out = pred.predict(imgs, qs, top_k=5)  # one rank_answer call at B=16
    torch.cuda.synchronize()
    launches = read_counts()
    reset_counts()
    single_out = pred.predict(imgs[:1], qs[:1], top_k=5)  # the B=1 bucket
    torch.cuda.synchronize()
    single_launches = read_counts()
    want = {**NO_LAUNCHES, "flash_attention": 54}
    print(f"albef: rank_answer through AlbefVqaPredictor.predict, attn_impl='flash', B={AB} "
          f"(S={VIT_S}, Lq={LQ}, La={LA}, k={ALBEF_K}, {len(ALBEF_ANSWERS)} answers): launches "
          f"{launches['flash_attention']} per batch, {single_launches['flash_attention']} per single "
          f"request (expected 54: ViT 12, text 6, fusion 12, stage-1 12, stage-2 12)")
    check(launches == want and single_launches == want,
          f"albef launches {launches} / {single_launches}, expected {want}")
    check(len(batch_out) == AB and all(len(r) == 5 for r in batch_out) and len(single_out) == 1,
          "bad ALBEF result shape")
    for row in batch_out + single_out:
        probs = [p for _, p in row]
        check(all(math.isfinite(p) and 0.0 <= p <= 1.0 for p in probs), f"bad probabilities {row}")
        check(probs == sorted(probs, reverse=True), "top-k not in descending order")
        check(all(a in ALBEF_ANSWERS for a, _ in row), f"answer outside the bank: {row}")
    print(f"albef: first answers {[r[0] for r in batch_out[:3]]}; single {single_out[0][:2]}")

    batch = pred._preprocess(imgs, qs)
    t = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    state = pred.model.state_dict()
    plain = albef_predictor(torch, seed, "auto")
    exact = albef_predictor(torch, seed, "auto", "float32")
    for other in (plain, exact):
        other.model.load_state_dict(state)
    stages = {"kernel": albef_stages(torch, pred, t)}
    ranked = {"kernel": pred.rank(batch)}
    torch.cuda.synchronize()
    before = read_counts()
    for name, p in (("plain", plain), ("exact", exact)):
        stages[name], ranked[name] = albef_stages(torch, p, t), p.rank(batch)
    torch.cuda.synchronize()
    check(read_counts() == before, "the plain path launched a kernel")
    tol = ALBEF_FLOOR
    for i, what in enumerate(("question states", "stage-1 logits")):
        k_err = rel_norm(stages["kernel"][i], stages["exact"][i])
        p_err = rel_norm(stages["plain"][i], stages["exact"][i])
        lim = max(ALBEF_FACTOR * p_err, ALBEF_FLOOR)
        tol = max(tol, lim)
        print(f"albef: {what} vs plain fp32: kernel path {k_err:.3e}, plain bf16 path {p_err:.3e}; "
              f"limit {lim:.3e}")
        check(k_err <= lim, f"albef {what} disagree: {k_err} > {lim}")
    top = {name: ids[:, 0] for name, (ids, _) in ranked.items()}
    ex_p = ranked["exact"][1]
    agree_plain = int((top["kernel"] == top["plain"]).sum())
    agree_exact = int((top["kernel"] == top["exact"]).sum())
    plain_exact = int((top["plain"] == top["exact"]).sum())
    gaps = (ex_p[:, 0] - ex_p[:, 1]) / ex_p[:, 0]
    off = np.nonzero(top["kernel"] != top["exact"])[0]
    print(f"albef: top-1 agreement kernel/plain bf16 {agree_plain}/{AB}, kernel/plain fp32 "
          f"{agree_exact}/{AB}, plain bf16/plain fp32 {plain_exact}/{AB}; fp32 top-2 relative gaps "
          f"at the disagreements {[round(float(gaps[i]), 4) for i in off]} (allowed <= {tol:.3e}); "
          f"fp32 top-1 probabilities {np.round(ex_p[:, 0], 3).tolist()}")
    check(all(gaps[i] <= tol for i in off), "a top-1 answer differs where the fp32 path is not near a tie")
    del exact, stages, ranked
    torch.cuda.empty_cache()
    return dict(pred=pred, plain=plain, batch=batch, requests=(imgs, qs), launches=launches)


# ALBEF DAT training (slice 5): bench.py's _build_albef batch, B=48 questions
# with A=4 weighted answers each, dropout live at ALBEF's 0.1 (the users'
# setting) or off.  The plain fp32 path fits at this batch (about 51 GiB), so
# the gradient check runs at it too.
ATB, ANS_PER_Q = 48, 4


def albef_train_model(torch, seed, attn_impl, dtype="bfloat16", dropout=True, state=None,
                      encoder="albef_no_distill", mode="dat", **flags):
    """Full-width ALBEF (DAT unless ``mode`` says otherwise) from
    ``create_model`` (its dropout 0.1 live), or the same configuration with
    both BERT rates at 0; weights from ``seed`` or ``state``; ``flags``:
    create_model's remat and logits arguments."""
    import dataclasses

    from feddat_tpu_torch.configs.core import PEFTMode
    from feddat_tpu_torch.models import DTYPES, create_model
    from feddat_tpu_torch.models.albef import AlbefModel

    # weights to be loaded need no random init (seconds per full-width ALBEF)
    model, cfg = create_model(encoder, {}, PEFTMode(mode), 16, dtype, attn_impl=attn_impl,
                              seed=seed if state is None else None, **flags)
    check((cfg.bert.hidden_dropout, cfg.bert.attention_dropout) == (0.1, 0.1)
          and cfg.image_res == ARES and cfg.max_question_len == LQ and cfg.max_answer_len == LA,
          f"unexpected ALBEF config {cfg}")
    if not dropout:
        cfg = dataclasses.replace(cfg, bert=dataclasses.replace(cfg.bert, hidden_dropout=0.0,
                                                                attention_dropout=0.0))
        sd = model.state_dict() if state is None else state
        # create_model's routes: "block"/"layer" take the ViT alone
        routes = (dict(attn_impl="auto", vision_attn_impl=attn_impl)
                  if attn_impl in ("block", "layer") else dict(attn_impl=attn_impl))
        with torch.device("meta"):
            model = AlbefModel(cfg, DTYPES[dtype], **routes)
        model = model.to_empty(device="cuda")
        model.load_state_dict(sd)
    elif state is not None:
        model.load_state_dict(state)
    return model


def albef_train_batch(torch, b, seed, res=ARES):
    """bench.py's ALBEF batch on the card: random pixels (``res`` square), 25
    question tokens, A answers of 10 tokens at weight 1/A."""
    import numpy as np

    from feddat_tpu_torch.train.forwards import to_device

    rng = np.random.RandomState(seed)
    batch = {
        "pixel_values": rng.randn(b, res, res, 3).astype(np.float32),
        "question_ids": rng.randint(5, 30522, size=(b, LQ)).astype(np.int32),
        "question_mask": np.ones((b, LQ), np.int32),
        "answer_ids": rng.randint(5, 30522, size=(b, ANS_PER_Q, LA)).astype(np.int32),
        "answer_mask": np.ones((b, ANS_PER_Q, LA), np.int32),
        "answer_weights": np.full((b, ANS_PER_Q), 1.0 / ANS_PER_Q, np.float32),
    }
    return to_device(batch, torch.device("cuda"))


def albef_fused_step(torch, model, params, seed):
    """(make_albef_fused_dat_step's step, its initial state from ``seed``)."""
    from feddat_tpu_torch.configs.core import OptimizerConfig
    from feddat_tpu_torch.train import dat
    from feddat_tpu_torch.train.trainers import make_albef_fused_dat_step

    opt = OptimizerConfig()
    step, part = make_albef_fused_dat_step(model, params, opt, 10_000)
    return step, dat.init_train_state(params, part, opt, torch.Generator().manual_seed(seed))


FLASH_KEYS = ("flash_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")


def flash_launches(counts):
    return "/".join(str(counts[k]) for k in FLASH_KEYS)


def phase_albef_train(torch, seed):
    """Full-width ALBEF DAT training through attn_impl='flash' and the fused
    step: (a) the users' setting, dropout 0.1 live (flash at the ViT sites
    only); (b) dropout off (flash at every site) with the 2x-bf16 gradient
    rule at the same batch; (c) one FederatedTrainer round of two synthetic
    clients and its rank-answer evaluate_dat."""
    from feddat_tpu_torch.configs.core import FederatedConfig, OptimizerConfig, PEFTMode, TrainConfig
    from feddat_tpu_torch.data.synthetic import SyntheticAlbefClient
    from feddat_tpu_torch.federated.engine import FederatedTrainer
    from feddat_tpu_torch.train.trainers import resolve_trainer

    # (a) dropout live: 12 ViT sites per encoder pass, block 0 without a backward
    model = albef_train_model(torch, seed, "flash")
    cfg = model.cfg
    vit, text = cfg.vision_layers, cfg.bert.fusion_layer
    fusion, dec = cfg.bert.num_layers - text, cfg.decoder_layers
    params = {n: t.detach() for n, t in model.state_dict().items()}
    batch = albef_train_batch(torch, ATB, seed)
    step, state0 = albef_fused_step(torch, model, params, seed)
    torch.cuda.synchronize()
    reset_counts()
    state, m = step(state0, batch)
    torch.cuda.synchronize()
    launches = read_counts()
    want = {**NO_LAUNCHES, "flash_attention": 2 * vit, "flash_attention_bwd_dq": 2 * (vit - 1),
            "flash_attention_bwd_dkv": 2 * (vit - 1)}
    print(f"albef_train: fused DAT step, dropout 0.1 live, attn_impl='flash', B={ATB} A={ANS_PER_Q} "
          f"(S={VIT_S}, Lq={LQ}, La={LA}): #7/#8/#9 launches {flash_launches(launches)} (expected "
          f"{flash_launches(want)}: the {vit} ViT sites of 2 encoder passes, forward and backward; "
          f"block 0's attention input depends on no trainable parameter, so it has no backward; the "
          f"BERT sites carry attention dropout and take the composable path)")
    check(launches == want, f"albef_train launches {launches}, expected {want}")
    losses = [(float(m["loss"]), float(m["loss_shared"]))]
    for _ in range(2):
        state, mm = step(state, batch)
        losses.append((float(mm["loss"]), float(mm["loss_shared"])))
    _, again = step(state0, batch)
    _, other = step(state0.replace(rng=torch.Generator().manual_seed(seed + 1)), batch)
    torch.cuda.synchronize()
    same = [float(again[k]) == float(m[k]) for k in ("loss", "loss_shared")]
    moved = [abs(float(other[k]) - float(m[k])) for k in ("loss", "loss_shared")]
    print(f"albef_train: fused steps (loss, loss_shared) {[tuple(round(v, 4) for v in l) for l in losses]}; "
          f"the step again from the same state (seed {seed}): equal {same}; from generator seed "
          f"{seed + 1}: losses move by {moved[0]:.3e}, {moved[1]:.3e}")
    check(all(math.isfinite(v) for l in losses for v in l), "non-finite ALBEF train loss")
    check(all(same) and min(moved) > 0.0, "dropout masks are not a function of the state's generator")
    del state, mm, again, other

    # (b) dropout off: every site through flash; no backward at ViT block 0,
    # text layer 0's self-attention and decoder layer 0's self-attention
    sd = model.state_dict()
    off = albef_train_model(torch, seed, "flash", dropout=False, state=sd)
    step_off, _ = albef_fused_step(torch, off, params, seed)
    torch.cuda.synchronize()
    reset_counts()
    _, kernel_m = step_off(state0, batch)
    torch.cuda.synchronize()
    off_launches = read_counts()
    per_pass = vit + text + 2 * fusion + 2 * dec
    want_off = {**NO_LAUNCHES, "flash_attention": 2 * per_pass,
                "flash_attention_bwd_dq": 2 * (per_pass - 3), "flash_attention_bwd_dkv": 2 * (per_pass - 3)}
    print(f"albef_train: fused DAT step, dropout off, B={ATB}: #7/#8/#9 launches "
          f"{flash_launches(off_launches)} (expected {flash_launches(want_off)}: per pass {vit} ViT + "
          f"{text} text self + {fusion} fusion self and cross + {dec} decoder self and cross = "
          f"{per_pass} sites, of which ViT block 0, text layer 0 self and decoder layer 0 self need "
          f"no backward); loss {float(kernel_m['loss']):.4f}")
    check(off_launches == want_off, f"albef_train dropout-off launches {off_launches}, expected {want_off}")

    # the same step on the plain path in bf16 and in fp32, for the 2x-bf16 rule
    del step_off
    before = read_counts()
    plain = albef_train_model(torch, seed, "auto", dropout=False, state=sd)
    plain_m = albef_fused_step(torch, plain, params, seed)[0](state0, batch)[1]
    del plain
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    exact = albef_train_model(torch, seed, "auto", "float32", dropout=False, state=sd)
    exact_m = albef_fused_step(torch, exact, params, seed)[0](state0, batch)[1]
    torch.cuda.synchronize()
    print(f"albef_train: plain fp32 fused step at B={ATB}: peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    check(read_counts() == before, "the plain path launched a kernel")
    del exact, off
    grad_ratio = grad_agreement(torch, f"albef fused step, dropout off, B={ATB}", kernel_m,
                                plain_m, exact_m)
    del kernel_m, plain_m, exact_m
    torch.cuda.empty_cache()

    # (c) one round of two clients, dropout live, and its evaluation
    clients = {k: SyntheticAlbefClient(k, num_train=2 * ATB, num_eval=ATB, num_answers=len(ALBEF_ANSWERS),
                                       vocab_size=30522, question_len=LQ, answer_len=LA,
                                       max_answers_per_q=ANS_PER_Q, image_size=(ARES, ARES),
                                       batch_size=ATB, val_batch_size=ATB, seed=seed + 1 + i)
               for i, k in enumerate(TRAIN_CLIENTS)}
    hooks = resolve_trainer("albef_no_distill", "vqa", rank_k=ALBEF_K, answer_banks={
        k: (c.answer_ids, c.answer_mask) for k, c in clients.items()})
    tcfg = TrainConfig(encoder_name="albef_no_distill", peft_mode=PEFTMode.DAT,
                       optimizer=OptimizerConfig(),
                       federated=FederatedConfig(comm_rounds=1, local_epochs=1, eval_every=1),
                       num_epochs=1, seed=seed)
    trainer = FederatedTrainer(model, params, clients, tcfg, make_forward=hooks.make_forward,
                               make_eval=hooks.make_eval, use_fused_dat=True)
    reset_counts()
    t0 = time.perf_counter()
    trainer.run_round(0)
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    round_launches = read_counts()
    entry = trainer.evaluate_round(0)
    torch.cuda.synchronize()
    steps = 2 * len(clients)
    print(f"albef_train: FederatedTrainer round of {len(clients)} clients x 2 fused steps (dropout "
          f"live) in {round_s:.2f} s, #7/#8/#9 launches {flash_launches(round_launches)}; "
          f"evaluate_dat (rank_answer, k={ALBEF_K} of {len(ALBEF_ANSWERS)}) {entry['scores']}")
    check(round_launches == {k: steps * v for k, v in want.items()}, f"round launches {round_launches}")
    for key, scores in entry["scores"].items():
        check(len(scores) == 3 and all(math.isfinite(v) and 0.0 <= v <= 100.0 for v in scores),
              f"bad evaluate_dat scores for {key}: {scores}")
    sites = vit + text + fusion + dec
    moved = [k for k, v in trainer.server_params.items() if "adapter_1" in k and not torch.equal(v, params[k])]
    check(len(moved) == 4 * sites and all(bool(torch.isfinite(trainer.server_params[k]).all()) for k in moved),
          f"FedAvg moved {len(moved)} adapter_1 tensors, expected {4 * sites}")
    personal = [trainer.personal[k]["visual_encoder.blocks.0.adapter.adapter_0_up.bias"]
                for k in TRAIN_CLIENTS]
    check(not torch.equal(*personal), "the clients' personal adapter_0 were averaged")
    del trainer, clients
    torch.cuda.empty_cache()
    return dict(model=model, params=params, batch=batch, state0=state0, launches=launches,
                grad_ratio=grad_ratio, round_s=round_s)


def flash_bwd_bound(b, sq, skv, bias_numel, part, f32=False):
    """Least time (ms) for one #8 (``part="dq"``) or #9 (``"dkv"``) call and
    what bounds it.  Tensor cores: s = q.k^T and dP = dO.v^T on bf16 operands
    at the bf16 peak (at the TF32 peak with ``f32``); ds.k (#8), or p^T.dO and
    ds^T.q (#9), with p and ds at fp32 precision at the TF32 peak.  Beside them
    on the CUDA cores ~8 fp32 operations per logit (scale, bias, exp, dP -
    delta, products); the pipes overlap.  Bytes: q, k, v, dO and the outputs
    in bf16 (fp32 with ``f32``), lse and delta in fp32 and the compact bias,
    once each."""
    d = DM // HEADS
    prod = 2 * b * HEADS * sq * skv * d
    fp_products = 1 if part == "dq" else 2
    t_ops = max(2 * prod / tensor_peak(f32) + fp_products * prod / PEAK_TF32_FLOPS,
                8 * b * HEADS * sq * skv / PEAK_FP32_FLOPS)
    outputs = b * HEADS * (sq if part == "dq" else 2 * skv) * d
    nbytes = ((2 * b * HEADS * (sq + skv) * d + outputs) * (4 if f32 else 2) + 2 * b * HEADS * sq * 4
              + bias_numel * 4)
    t_bytes = nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"),
            (2 + fp_products) * prod)


def time_albef_train(torch, at, seed):
    """#8 and #9 at ALBEF's ViT shape (B=16, H=12, S=577, no bias; #7's row):
    each kernel, the plain backward, autograd.grad through SDPA (a yardstick
    the port never calls) and the bounds.  Then ALBEF fused-step samples/s,
    kernel path against plain path (attn_impl='auto'), dropout live, in
    alternating samples with each path's peak memory, and a profile of one
    kernel-path step."""
    import torch.nn.functional as F

    from feddat_tpu_torch.ops import flash as fl

    q, k, v, _ = flash_case(torch, AB, VIT_S, VIT_S, "none", seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    do = torch.randn(q.shape, generator=g, device="cuda").bfloat16()
    scale = 64 ** -0.5
    with torch.no_grad():
        o, lse = fl.flash_attention_fwd_cuda(q, k, v, None, scale)
        run_dq, run_dkv, _ = fl.flash_bwd_launchers(q, k, v, None, o, do, lse, scale)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves)

    rows = {}
    for name, part, run in (("flash_attention_bwd_dq", "dq", run_dq), ("flash_attention_bwd_dkv", "dkv", run_dkv)):
        rows[name] = time_row(
            torch, f"{name} B={AB} H={HEADS} S={VIT_S}", run,
            lambda: fl.flash_attention_bwd_ref(q, k, v, None, o, do, lse, scale),
            lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
            flash_bwd_bound(AB, VIT_S, VIT_S, 0, part), "autograd.grad through SDPA: dq, dk, dv; plain: the same")
    del out, leaves
    pair = rows["flash_attention_bwd_dq"][0] + rows["flash_attention_bwd_dkv"][0]
    print(f"time flash backward: #8 + #9 {pair:.4f} ms device, {pair / rows['flash_attention_bwd_dq'][2]:.2f}x "
          f"the library's")

    model, params, batch, state0 = at["model"], at["params"], at["batch"], at["state0"]
    step, _ = albef_fused_step(torch, model, params, seed)
    plain_model = albef_train_model(torch, seed, "auto", state=model.state_dict())
    plain_step, _ = albef_fused_step(torch, plain_model, params, seed)

    def sample(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            fn(state0, batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 2

    peak = {}
    for name, fn in (("kernel", step), ("plain", plain_step)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sample(fn)
        peak[name] = torch.cuda.max_memory_allocated() / 2 ** 30
    k_s, p_s = [], []
    for i in range(TIME_PAIRS):
        for path in ((step, plain_step) if i % 2 == 0 else (plain_step, step)):
            (k_s if path is step else p_s).append(sample(path))
    k_med, p_med = statistics.median(k_s), statistics.median(p_s)
    wins = sum(a < b for a, b in zip(k_s, p_s))
    print(f"time albef_train: fused DAT step B={ATB} A={ANS_PER_Q}, dropout live, {TIME_PAIRS} alternating pairs of "
          f"2 steps: medians {1e3 * k_med:.1f} vs {1e3 * p_med:.1f} ms per step (kernel vs plain path); "
          f"{ATB / k_med:.1f} vs {ATB / p_med:.1f} samples/s; kernel path faster in {wins}/{TIME_PAIRS}; peak "
          f"memory {peak['kernel']:.2f} vs {peak['plain']:.2f} GiB; kernel "
          f"{[round(1e3 * v, 1) for v in k_s]} plain {[round(1e3 * v, 1) for v in p_s]}")
    del plain_model, plain_step
    torch.cuda.empty_cache()
    profile_device(torch, lambda: step(state0, batch), f"ALBEF fused DAT step (flash, B={ATB})", {
        "#7 flash_fwd": ("flash_fwd_kernel",), "#8 flash_bwd_dq": ("flash_bwd_dq_kernel",),
        "#9 flash_bwd_dkv": ("flash_bwd_dkv_kernel",)})
    # host cost of one call_method (functional_call swaps every parameter in
    # and out); the fused step makes 5: two encoder passes, three head calls
    from feddat_tpu_torch.train.forwards import call_method

    tiny = torch.zeros(1, 2, model.cfg.bert.hidden_size, device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        swap_ms = 1e3 * sample(lambda *_: [call_method(model, params, "apply_cls", tiny) for _ in range(5)]) / 5
    print(f"time albef_train host: one call_method over {len(params)} tensors (apply_cls on [1, 2, "
          f"{tiny.shape[-1]}]) {swap_ms:.2f} ms; the fused step makes 5")
    return rows, ATB / k_med, ATB / p_med


def time_albef(torch, al, seed):
    """#7 at the ViT and packed-decoder shapes (kernel, plain, SDPA with the
    same float mask), rank-answer questions/s kernel vs plain path in
    alternating samples, predict() rates, and a profile of one rank_answer."""
    import torch.nn.functional as F

    from feddat_tpu_torch.ops import flash as fl

    rows = []
    for site, b, sq, skv, kind in (FLASH_CASES[0], FLASH_CASES[5]):
        q, k, v, bias = flash_case(torch, b, sq, skv, kind, seed)
        mask = None if bias is None else bias.bfloat16()
        with torch.no_grad():
            rows.append((site, *time_row(
                torch, f"flash_attention {site} B={b} Sq={sq} Skv={skv}",
                lambda: fl.flash_attention_fwd_cuda(q, k, v, bias, 0.125),
                lambda: fl.flash_attention_fwd_ref(q, k, v, bias, 0.125),
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
                flash_bound(b, sq, skv, 0 if bias is None else bias.numel()), "SDPA with the float mask")))

    pred, plain, batch = al["pred"], al["plain"], al["batch"]

    def sample(p):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            p.rank(batch)
        return (time.perf_counter() - t0) / 2  # rank() ends in a copy to the host

    for p in (pred, plain):
        sample(p)
    k_s, p_s = [], []
    for i in range(TIME_PAIRS):
        for p in ((pred, plain) if i % 2 == 0 else (plain, pred)):
            (k_s if p is pred else p_s).append(sample(p))
    k_med, p_med = statistics.median(k_s), statistics.median(p_s)
    wins = sum(a < b for a, b in zip(k_s, p_s))
    print(f"time albef: rank_answer B={AB}, {TIME_PAIRS} alternating pairs of 2 calls: medians "
          f"{1e3 * k_med:.1f} vs {1e3 * p_med:.1f} ms (kernel vs plain path); {AB / k_med:.1f} vs "
          f"{AB / p_med:.1f} questions/s; kernel path faster in {wins}/{TIME_PAIRS}; kernel "
          f"{[round(1e3 * v, 1) for v in k_s]} plain {[round(1e3 * v, 1) for v in p_s]}")
    imgs, qs = al["requests"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        pred.predict(imgs, qs, top_k=5)
    predict_s = (time.perf_counter() - t0) / 2
    single_ms = []
    for i in range(7):
        t0 = time.perf_counter()
        pred.predict(imgs[i : i + 1], qs[i : i + 1], top_k=5)
        single_ms.append(1e3 * (time.perf_counter() - t0))
    single_ms.sort()
    print(f"time albef: predict() {AB / predict_s:.1f} questions/s ({1e3 * predict_s:.1f} ms per batch "
          f"of {AB}, host preprocessing included); single request (B=1 bucket) p50 "
          f"{single_ms[3]:.1f} ms, max {single_ms[-1]:.1f} ms over {len(single_ms)}")
    profile_device(torch, lambda: pred.rank(batch), f"rank_answer (flash, B={AB})",
                   {"#7 flash_fwd_kernel": ("flash_fwd",)})
    return rows, AB / k_med, AB / p_med


def time_fused_kernels(torch, seed):
    """#5 and #6 at the training shape (B=64, S=185), then at the serving
    canvas (B=16, S=281): kernel, plain version, SDPA forward / autograd.grad
    through SDPA (yardsticks the port never calls) and the bound; the device
    time of each launch of one #6 call (dq with delta, then dk/dv) at the
    training shape.  Returns the training shape's rows."""
    import torch.nn.functional as F

    from feddat_tpu_torch.ops import fused_attention as fa

    rows = {}
    for b, s in ((TB, TS), (B, S)):
        q, k, v, do = fused_inputs(torch, b, s, seed)
        bias = padding_bias(torch, b, s, seed)
        scale = 64 ** -0.5
        with torch.no_grad():
            o, lse = fa.fused_attention_fwd_cuda(q, k, v, bias, scale)
        fwd = time_row(
            torch, f"fused_attention B={b} S={s}", lambda: fa.fused_attention_fwd_cuda(q, k, v, bias, scale),
            lambda: fa.fused_attention_fwd_ref(q, k, v, bias, scale),
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias.bfloat16()),
            fused_attention_bound(b, s, False), "SDPA with the mask")
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, attn_mask=bias.bfloat16())
        bwd = time_row(
            torch, f"fused_attention_bwd B={b} S={s}",
            lambda: fa.fused_attention_bwd_cuda(q, k, v, bias, o, do, lse, scale),
            lambda: fa.fused_attention_bwd_ref(q, k, v, bias, o, do, lse, scale),
            lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
            fused_attention_bound(b, s, True), "autograd.grad through SDPA")
        if not rows:
            rows = {"fused_attention": fwd, "fused_attention_bwd": bwd}
            launch_breakdown(torch, lambda: fa.fused_attention_bwd_cuda(q, k, v, bias, o, do, lse, scale),
                             f"#6 B={b} S={s} (dq with delta, then dk/dv)")
        del out, leaves
    return rows


def time_peft(torch, pf, seed):
    """LoRA train samples/s: kernel path (attn_impl='fused') against the port's
    plain path (attn_impl='auto' with bf16 logits, the CLI default under
    --dtype bfloat16) in alternating samples of 2 steps; a profile of one step."""
    step, _, _ = peft_step(pf["model"], "lora", pf["params"])
    plain_model = peft_model(torch, "lora", seed, "auto", logits="bfloat16", state=pf["model"].state_dict())
    plain_step, _, _ = peft_step(plain_model, "lora", pf["params"])
    batch, state0 = pf["batch"], pf["state0"]

    def sample(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            fn(state0, batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 2

    for fn in (step, plain_step):
        sample(fn)
    k_s, p_s = [], []
    for i in range(TIME_PAIRS):
        for path in ((step, plain_step) if i % 2 == 0 else (plain_step, step)):
            (k_s if path is step else p_s).append(sample(path))
    k_med, p_med = statistics.median(k_s), statistics.median(p_s)
    wins = sum(a < b for a, b in zip(k_s, p_s))
    print(f"time peft: LoRA step B={TB} S={TS}, {TIME_PAIRS} alternating pairs of 2 steps: medians "
          f"{1e3 * k_med:.1f} vs {1e3 * p_med:.1f} ms per step (kernel vs plain path); "
          f"{TB / k_med:.1f} vs {TB / p_med:.1f} samples/s; kernel path faster in {wins}/{TIME_PAIRS}; "
          f"kernel {[round(1e3 * v, 1) for v in k_s]} plain {[round(1e3 * v, 1) for v in p_s]}")
    profile_device(torch, lambda: step(state0, batch), f"LoRA step (fused, B={TB})", {
        "#5 fused_fwd_kernel": ("fused_fwd_kernel",), "#6 fused_bwd": ("fused_bwd_",)})
    return TB / k_med, TB / p_med


# The four FFN products of #4 at the training shape, by the name of their
# gemm_sm90_kernel<layout, epilogue> instance in #4's launch order (the first
# <1, 2> is g_m; the second is the attention's dx): label, name, N, K, B_NT?
FFN_GEMMS = (("FFN1 p1 = m.W1^T (NT)", "gemm_sm90_kernel<0, 3>", 3072, DM, True),
             ("FFN2 o = ge.W2^T (NT)", "gemm_sm90_kernel<0, 4>", DM, 3072, True),
             ("g_p1 = g_f.W2 (NN)", "gemm_sm90_kernel<1, 5>", 3072, DM, False),
             ("g_m = g_p1.W1 (NN)", "gemm_sm90_kernel<1, 2>", DM, 3072, False))


def gemm_against_cublas(torch, breakdown, seed):
    """The wgmma GEMM's rate on #4's four FFN products (device ms from one #4
    call's breakdown) beside cuBLAS's torch.mm at the same shapes with bf16
    output (device_ms), a yardstick the port never calls."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    m = TB * TS
    for label, name, n, k, nt in FFN_GEMMS:
        ms = next((t for kname, t in breakdown if name in kname), None)
        a = torch.randn(m, k, generator=g, device="cuda").bfloat16()
        w = torch.randn(n, k, generator=g, device="cuda").bfloat16()
        wt = w.t().contiguous()  # [K, N] for the NN layout
        lib = device_ms(torch, (lambda: torch.mm(a, w.t())) if nt else (lambda: torch.mm(a, wt)))
        flop = 2 * m * n * k
        mine = "not in the breakdown" if ms is None else f"{ms:.4f} ms ({flop / ms / 1e9:.1f} TFLOP/s)"
        print(f"gemm {label} M={m} N={n} K={k}: gemm_sm90 {mine}; cuBLAS torch.mm {lib:.4f} ms "
              f"({flop / lib / 1e9:.1f} TFLOP/s)")


def attention_chain(torch, b, s, fuse_ln):
    """The attention part of #3/#4's library yardstick at one shape:
    (F.layer_norm when ``fuse_ln``,) F.linear q/k/v, SDPA with the mask."""
    import torch.nn.functional as F

    def heads(t):
        return t.view(b, s, HEADS, DM // HEADS).transpose(1, 2)

    def attention(xr, gamma, wq, wk, wv, bqkv, bias):
        dt = xr.dtype
        xl = (F.layer_norm(xr, (DM,), gamma[0].to(dt), gamma[1].to(dt), 1e-12) if fuse_ln else xr)
        q, k, v = (heads(F.linear(xl, w, bqkv[i].to(dt))) for i, w in enumerate((wq, wk, wv)))
        mask = None if bias is None else bias.to(dt)
        att = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        return att.transpose(1, 2).reshape(b, s, DM)

    return attention


def attn_bwd_row(torch, b, s, fuse_ln, seed, masked=True, dtype=None):
    """#3's time row at one shape: kernel, plain version, the library chain
    (the forward from x inside the timed call and autograd.grad through it)
    and the bound -> (row, args, attention chain).  bf16, or ``dtype``."""
    from feddat_tpu_torch.ops import attn_block as ab

    args = attn_bwd_case(torch, b, s, fuse_ln, seed, masked, dtype)
    f32 = dtype == torch.float32
    x, wq, wk, wv, wo, bqkv, gb, bias, ctx, lse, gout = args[:11]
    attention = attention_chain(torch, b, s, fuse_ln)

    def chain3():
        with torch.enable_grad():
            xr = x.detach().requires_grad_()
            dctx = torch.mm(gout.view(-1, DM), wo).view_as(x)
            return torch.autograd.grad(attention(xr, gb, wq, wk, wv, bqkv, bias), [xr], dctx)

    row = time_row(
        torch, f"attn_block_bwd B={b} S={s} ln={fuse_ln}{'' if masked else ' unmasked'}"
        + (" fp32" if f32 else ""),
        lambda: ab.attn_block_bwd_cuda(*args), lambda: ab.attn_block_bwd_reference(*args), chain3,
        attn_bwd_bound(b, s, fuse_ln, masked, f32), "the forward from x and autograd.grad through it")
    return row, args, attention


def layer_bwd_row(torch, b, s, use_b, seed, masked=True, r=R, dtype=None):
    """#4's time row at one shape, as :func:`attn_bwd_row` -> (row, args, cfg,
    the layer's library forward).  Adapters of bottleneck ``r``, bf16 or
    ``dtype``."""
    import torch.nn.functional as F

    from feddat_tpu_torch.ops import layer_block as lb

    largs, cfg = layer_case(torch, b, s, use_b, seed, masked, r=r, dtype=dtype)
    f32 = dtype == torch.float32
    (x, aout, ctx, lse, gout, bias, wq, wk, wv, wo, bqkv, gb1, gb2, w1, b1, w2, b2,
     wda, bda, wua, bua, wdb, bdb, wub, bub) = largs
    attention = attention_chain(torch, b, s, True)
    w_a, w_b = cfg[4], cfg[5]

    def layer(xr, pa):
        dt = xr.dtype
        h = xr + F.linear(attention(xr, gb1, wq, wk, wv, bqkv, bias), wo)
        mid = F.gelu(F.linear(F.layer_norm(h, (DM,), gb2[0].to(dt), gb2[1].to(dt), 1e-12), w1, b1[0].to(dt)))
        o = h + F.linear(mid, w2, b2[0].to(dt))

        def adapter(wd, bd, wu, bu):
            return F.linear(F.relu(F.linear(o, wd.t(), bd[0].to(dt))), wu.t(), bu[0].to(dt))

        out = o + w_a * adapter(*pa)
        return out + w_b * adapter(wdb, bdb, wub, bub) if use_b else out

    def chain4():
        with torch.enable_grad():
            xr = x.detach().requires_grad_()
            pa = [t.detach().requires_grad_() for t in (wda, bda, wua, bua)]
            return torch.autograd.grad(layer(xr, pa), [xr, *pa], gout)

    row = time_row(
        torch, f"layer_block_bwd B={b} S={s} ensemble={use_b}{'' if masked else ' unmasked'}"
        + ("" if r == R else f" R={r}") + (" fp32" if f32 else ""),
        lambda: lb.layer_block_bwd_cuda(*largs, *cfg), lambda: lb.layer_block_bwd_reference(*largs, *cfg),
        chain4, layer_bwd_bound(b, s, use_b, masked=masked, r=r, f32=f32),
        "the forward from x and autograd.grad through it")
    return row, largs, cfg, layer


def time_backward_kernels(torch, seed):
    """#3 and #4 at the training shape: kernel, plain version, a library
    chain for the same function and the bound; each kernel's launches by
    device time, and the GEMM's FFN products beside cuBLAS.  The library chain
    (F.layer_norm/F.linear/SDPA/F.gelu in bf16) runs the forward from x inside
    the timed call and autograd.grad through it, so it recomputes what the
    kernel recomputes (LN1 and q/k/v; for #4 also h, m, p1, o) and more (the
    attention forward; for #4 the out projection).  The old chain, autograd
    through a graph retained from one forward, is printed beside it."""
    import torch.nn.functional as F

    from feddat_tpu_torch.ops import attn_block as ab
    from feddat_tpu_torch.ops import layer_block as lb

    rows = {}
    rows["attn_block_bwd"], args, attention = attn_bwd_row(torch, TB, TS, True, seed)
    x, wq, wk, wv, wo, bqkv, gb, bias, ctx, lse, gout = args[:11]
    x_req = x.detach().requires_grad_()
    out = F.linear(attention(x_req, gb, wq, wk, wv, bqkv, bias), wo)
    old3 = device_ms(torch, lambda: torch.autograd.grad(out, [x_req], gout, retain_graph=True))
    print(f"time attn_block_bwd library, old chain (autograd.grad through a retained graph): "
          f"{old3:.4f} ms device")
    del out
    launch_breakdown(torch, lambda: ab.attn_block_bwd_cuda(*args), f"attn_block_bwd (#3) B={TB} S={TS}")

    rows["layer_block_bwd"], largs, cfg, layer = layer_bwd_row(torch, TB, TS, True, seed)
    x, gout, wda, bda, wua, bua = largs[0], largs[4], *largs[17:21]
    xr = x.detach().requires_grad_()
    pa = [t.detach().requires_grad_() for t in (wda, bda, wua, bua)]
    out = layer(xr, pa)
    old4 = device_ms(torch, lambda: torch.autograd.grad(out, [xr, *pa], gout, retain_graph=True))
    print(f"time layer_block_bwd library, old chain (autograd.grad through a retained graph): "
          f"{old4:.4f} ms device")
    del out
    breakdown = launch_breakdown(torch, lambda: lb.layer_block_bwd_cuda(*largs, *cfg),
                                 f"layer_block_bwd (#4) B={TB} S={TS}")
    gemm_against_cublas(torch, breakdown, seed)
    return rows


def time_train(torch, tr):
    """DAT train samples/s per card for the fused step: kernel path
    (attn_impl='layer') and plain path ('auto') in alternating samples of 2
    steps, on the same weights and a batch staged on the card."""
    step, _, _ = make_steps(tr["model"], tr["params"])
    plain_step, _, _ = make_steps(tr["plain_model"], tr["params"])
    batch, state0 = tr["batch"], tr["state0"]

    def sample(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            fn(state0, batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 2

    for fn in (step, plain_step):
        sample(fn)  # warm: cuBLAS handles, allocator
    k_s, p_s = [], []
    for i in range(TIME_PAIRS):
        for path in ((step, plain_step) if i % 2 == 0 else (plain_step, step)):
            (k_s if path is step else p_s).append(sample(path))
    k_med, p_med = statistics.median(k_s), statistics.median(p_s)
    wins = sum(a < b for a, b in zip(k_s, p_s))
    print(f"time train: fused DAT step B={TB} S={TS}, {TIME_PAIRS} alternating pairs of 2 steps: medians "
          f"{1e3 * k_med:.1f} vs {1e3 * p_med:.1f} ms per step (kernel vs plain path); "
          f"{TB / k_med:.1f} vs {TB / p_med:.1f} samples/s; kernel path faster in {wins}/{TIME_PAIRS}; "
          f"kernel {[round(1e3 * v, 1) for v in k_s]} plain {[round(1e3 * v, 1) for v in p_s]}")
    profile_device(torch, lambda: step(state0, batch), f"train step (fused DAT, B={TB})", {
        "port GEMMs (#1, #4; wgmma)": ("gemm_sm90_kernel",),
        "port attention (#1 fwd, #4 bwd)": ("block_core_",),
        "port row passes + adapter (#4)": ("ln2_fwd_rows", "ln_fwd_rows", "ln_bwd_rows", "adapter_"),
    })
    return TB / k_med, TB / p_med


def time_attn_block(torch, b, s, seed, fuse_ln=True, masked=True, dtype=None):
    """#1 at one shape (LN1 fused unless ``fuse_ln`` is off), bf16 or
    ``dtype``: kernel, plain version, the same function as one PyTorch call
    chain (a yardstick the port never calls) and the bound; then the device
    time of each of its launches (LN1 rows, q|k|v GEMM, attention core, out
    GEMM; in fp32 the operands' splits too)."""
    import torch.nn.functional as F

    from feddat_tpu_torch.ops import attn_block as ab

    args = attn_inputs(torch, b, s, fuse_ln, seed, masked, dtype=dtype)
    x, wq, wk, wv, wo, bqkv, bo, gb, bias = args[:9]
    attention = attention_chain(torch, b, s, fuse_ln)
    f32 = dtype == torch.float32

    def library():
        return F.linear(attention(x, gb, wq, wk, wv, bqkv, bias), wo, bo[0].to(x.dtype))

    label = (f"attn_block B={b} S={s}" + ("" if fuse_ln else " ln=False") + ("" if masked else " unmasked")
             + (" fp32" if f32 else ""))
    with torch.inference_mode():
        row = time_row(torch, label, lambda: ab.attn_block_cuda(*args),
                       lambda: ab.attn_block_reference(*args), library,
                       attn_block_bound(b, s, fuse_ln, masked, f32),
                       ("F.layer_norm + " if fuse_ln else "") + "F.linear + SDPA + F.linear")
        launch_breakdown(torch, lambda: ab.attn_block_cuda(*args), f"attn_block (#1) {label[11:]}")
    return row


# #2's timed shapes past R = 128 and D = 1024 (at the serving batch's rows).
ADAPTER_TIMED = ((192, DM), (384, DM), (80, 1280), (128, 2048))


def time_adapter(torch, n, seed, r=R, d=DM, dtype=None):
    """#2 at n rows, bottleneck r and width d, bf16 or ``dtype``: kernel,
    plain version, the torch.addmm chain (a yardstick the port never calls)
    and the bound; the device time of each launch of one call at the
    serving batch's R=48 in bf16."""
    from feddat_tpu_torch.ops import adapter_fused as af

    h, pa, pb, w = adapter_inputs(torch, n, seed, r, d, dtype)
    f32 = dtype == torch.float32

    def adapter_library():
        hf = h.float()
        fa = [t.float() for t in pa]
        fb = [t.float() for t in pb]
        a = torch.addmm(fa[3], torch.relu(torch.addmm(fa[1], hf, fa[0])), fa[2])
        b = torch.addmm(fb[3], torch.relu(torch.addmm(fb[1], hf, fb[0])), fb[2])
        return (w * a + (1.0 - w) * b).to(h.dtype)

    label = f"adapter_fused N={n}" + ("" if (r, d) == (R, DM) else f" R={r} D={d}") + (" fp32" if f32 else "")
    with torch.inference_mode():
        row = time_row(torch, label, lambda: af.adapter_fused_cuda(h, pa, pb, w),
                       lambda: af.adapter_fused_reference(h, pa, pb, w), adapter_library,
                       adapter_bound(n, r, d, f32), "torch.addmm chain" + (", fp32" if f32 else ""))
        if (n, r, d, f32) == (B * S, R, DM, False):
            launch_breakdown(torch, lambda: af.adapter_fused_cuda(h, pa, pb, w), f"adapter_fused (#2) N={n}")
    return row


def phase_time(torch, pred, plain, requests, seed):
    rows = {"attn_block": time_attn_block(torch, B, S, seed)}  # the JSON line's row
    time_attn_block(torch, TB, TS, seed)  # the training shape (the fused DAT step's 24 calls)

    # the serving batch (the JSON line's row), the B=1 bucket, and the serving
    # batch at the bottlenecks and widths past the first design's range
    rows["adapter_fused"] = time_adapter(torch, B * S, seed)
    time_adapter(torch, S, seed)
    for r, d in ADAPTER_TIMED:
        time_adapter(torch, B * S, seed, r, d)

    imgs, qs, batch = requests
    # kernel path vs plain path in alternating pairs (kp, pk, kp, ...), so
    # host-load drift hits both alike; each sample is 10 forwards
    k_samples, p_samples = [], []
    for i in range(2 * TIME_PAIRS):
        for path in ((pred, plain) if i % 2 == 0 else (plain, pred)):
            ms = cuda_ms(torch, lambda: path.forward(batch), 10, warmup=1)
            (k_samples if path is pred else p_samples).append(ms)
    fwd_ms, plain_fwd_ms = statistics.median(k_samples), statistics.median(p_samples)
    wins = sum(k < p for k, p in zip(k_samples, p_samples))
    print(f"time serve: forward kernel path vs plain path, {2 * TIME_PAIRS} alternating pairs: medians "
          f"{fwd_ms:.3f} vs {plain_fwd_ms:.3f} ms; kernel path faster in {wins}/{2 * TIME_PAIRS} pairs; "
          f"kernel {[round(v, 2) for v in k_samples]} plain {[round(v, 2) for v in p_samples]}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iters = 3
    for _ in range(iters):
        pred.predict(imgs, qs, top_k=5)
    predict_s = (time.perf_counter() - t0) / iters
    single_ms = []
    for i in range(11):  # one question at a time through the B=1 bucket
        t0 = time.perf_counter()
        pred.predict(imgs[i : i + 1], qs[i : i + 1], top_k=5)
        single_ms.append(1e3 * (time.perf_counter() - t0))
    single_ms.sort()
    print(f"time serve: single request (B=1 bucket) latency p50 {single_ms[5]:.2f} ms, "
          f"max {single_ms[-1]:.2f} ms over {len(single_ms)} requests")
    print(f"time serve: forward-only {B / (fwd_ms / 1e3):.1f} predictions/s "
          f"({fwd_ms:.3f} ms per batch of {B}); predict() {B / predict_s:.1f} predictions/s "
          f"({1e3 * predict_s:.1f} ms per batch, host preprocessing included); plain path "
          f"forward-only {B / (plain_fwd_ms / 1e3):.1f} predictions/s")
    profile_device(torch, lambda: pred.forward(batch), f"forward (B={B})",
                   {"attn_block": ("ln_fwd_rows", "gemm_sm90_kernel", "block_core_fwd_kernel"),
                    "adapter_fused": ("adapter_kernel",)})
    return rows


# ----------------------------------------------------------------- graphs
# The compiled layer (feddat_tpu_torch/train/compiled.py): every step, eval
# step and serving forward above ran under disable_graphs(), eagerly; here the
# same entry points run as users call them, captured as CUDA graphs at their
# first call and replayed after.  Each path: launch counts around one replay
# against the eager path's per call; two replayed steps (or calls) against
# two eager ones from the same state, bitwise where the eager path is
# bitwise run to run, else within twice its run-to-run spread; graph against
# eager in one pair for host launch calls, wall, device busy, idle share and
# peak memory.  One pair: the script has 1200 s on the card, and the pairs
# (3 until PR 14, 2 in PR 15) were the first depth cut when a phase was
# added; the port's bench is the place for timed pairs.
GRAPH_PAIRS = 1
HOST_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx", "cudaLaunchKernelExC")
# Every __global__ function of feddat_tpu_torch/csrc, and for each wrapper the
# one that its launch runs once and no other wrapper runs: #1's attention core
# and #3/#4's per-head part run #5/#6's code (csrc/attn_sm90.cuh) under entries
# of their own, and #4 runs #3's block_core_bwd_dq_kernel once per launch, so
# #3's count is that kernel's less #4's.
PORT_KERNELS = ("block_core_fwd_kernel", "block_core_bwd_dq_kernel", "block_core_bwd_dkdv_kernel",
                "adapter_kernel",
                "ln2_fwd_rows_kernel", "adapter_bwd_rows_kernel", "adapter_wgrad_kernel",
                "adapter_wgrad_reduce_kernel", "ln_fwd_rows_kernel", "ln_bwd_rows_kernel",
                "gemm_sm90_kernel", "fused_fwd_kernel", "fused_bwd_dq_kernel",
                "fused_bwd_dkdv_kernel", "flash_fwd_kernel", "flash_bwd_dq_kernel",
                "flash_bwd_dkv_kernel")
SIGNATURE = {"attn_block": "block_core_fwd_kernel", "adapter_fused": "adapter_kernel",
             "attn_block_bwd": "block_core_bwd_dq_kernel", "layer_block_bwd": "ln2_fwd_rows_kernel",
             "fused_attention": "fused_fwd_kernel", "fused_attention_bwd": "fused_bwd_dq_kernel",
             "flash_attention": "flash_fwd_kernel", "flash_attention_bwd_dq": "flash_bwd_dq_kernel",
             "flash_attention_bwd_dkv": "flash_bwd_dkv_kernel"}


def port_symbol(name):
    """The csrc ``__global__`` function a device kernel name (demangled or
    not) belongs to, or None."""
    for sym in PORT_KERNELS:
        if re.search(rf"(?<![A-Za-z_]){sym}(?![a-z_])", name):
            return sym
    return None


def device_launches(names):
    """Each wrapper's launches measured from a profile's device kernel names
    (a Counter), through :data:`SIGNATURE`."""
    syms = Counter()
    for name, n in names.items():
        syms[port_symbol(name)] += n
    out = {k: syms[sym] for k, sym in SIGNATURE.items()}
    out["attn_block_bwd"] -= out["layer_block_bwd"]
    return out


def graph_mode(graphs):
    from feddat_tpu_torch.train import compiled

    return contextlib.nullcontext() if graphs else compiled.disable_graphs()


def step_tensors(torch, out, i):
    """The tensors one step (``out = (state, metrics)``) or call (a tensor or
    a tuple of them) hands back, by name: losses, gradient sets, and the
    trainable partitions with their moments."""
    if isinstance(out, torch.Tensor):
        return {f"{i}/out": out}
    if isinstance(out, tuple) and not hasattr(out[0], "opt_states"):
        return {f"{i}/out{j}": t for j, t in enumerate(out)}
    state, metrics = out
    flat = {f"{i}/{k}": v for k, v in metrics.items() if isinstance(v, torch.Tensor)}
    for stage, grads in metrics.get("grads", {}).items():
        flat.update({f"{i}/grads/{stage}/{n}": g for n, g in grads.items()})
    for part, st in state.opt_states.items():
        for n in st.mu:
            flat.update({f"{i}/params/{n}": state.params[n], f"{i}/mu/{n}": st.mu[n],
                         f"{i}/nu/{n}": st.nu[n]})
    return flat


def run_calls(torch, call, graphs, n=3):
    """``n`` chained calls (``call(previous result or None)``) in one mode ->
    (their tensors by name, the launch counts of the first call)."""
    flat, prev, first = {}, None, None
    with graph_mode(graphs):
        for i in range(n):
            reset_counts()
            prev = call(prev)
            torch.cuda.synchronize()
            first = first or read_counts()
            flat.update(step_tensors(torch, prev, i))
    return flat, first


def graph_agreement(torch, label, graph, eager, eager2):
    """Replayed against eager results: bitwise where two eager runs are
    bitwise equal, else within twice their relative spread (Frobenius over
    all the tensors) -> the rule applied."""
    check(graph.keys() == eager.keys(), f"{label}: graph and eager results differ in names")
    exact = all(torch.equal(eager[k], eager2[k]) for k in eager)

    def spread(a, b):
        num = sum(float((a[k].double() - b[k].double()).pow(2).sum()) for k in a)
        den = sum(float(b[k].double().pow(2).sum()) for k in a)
        return (num / max(den, 1e-300)) ** 0.5

    if exact:
        bad = [k for k in eager if not torch.equal(graph[k], eager[k])]
        print(f"graphs: {label}: rule bitwise (eager is bitwise run to run): {len(eager)} tensors, "
              f"{len(bad)} differ{'' if not bad else ' e.g. ' + bad[0]}; graph vs eager relative "
              f"{spread(graph, eager):.3e}")
        check(not bad, f"{label}: replayed results differ from eager ones: {bad[:3]}")
        return "bitwise"
    g, e = spread(graph, eager), spread(eager2, eager)
    print(f"graphs: {label}: rule 2x run-to-run (eager is not bitwise run to run): graph vs eager "
          f"{g:.3e}, eager vs eager {e:.3e}")
    check(g <= 2.0 * e, f"{label}: replayed results {g} from eager, more than twice eager's {e}")
    return "2x run-to-run"


def call_profile(torch, label, modes, run, tries: int = 3):
    """:func:`call_profile_once`, taken again (``tries`` at most) when the
    profiler lost a call's events."""
    for _ in range(tries - 1):
        rows = call_profile_once(torch, label, modes, run)
        if rows is not None:
            return rows
        DEVICE_MS_STATS["again"] += 1
    rows = call_profile_once(torch, label, modes, run)
    check(rows is not None, f"graphs: {label}: the profile lost calls in {tries} profiles")
    return rows


def call_profile_once(torch, label, modes, run):
    """One torch.profiler profile of ``PROFILE_LEAD`` graph calls and then one
    call per entry of ``modes`` (True: graph, False: eager), a marker kernel
    before each call and after the last, a synchronize after each -> one row
    per call: host launch calls (kernel launches, graph launches, memcpys,
    fill ops), CUDA-event ms, device busy ms (and its share in dtype casts
    and copies by kernel, and in memcpys), peak allocated and reserved bytes,
    the set of kernel names and the count of each of the port's kernels by
    name; None if the profile lost calls."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.autograd.DeviceType.CUDA
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in modes]
    mem = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(PROFILE_LEAD + len(modes) + 1):
            with record_function(DEVICE_MS_MARK):
                torch.cuda._sleep(1000)
            j = i - PROFILE_LEAD
            if 0 <= j < len(modes):
                torch.cuda.reset_peak_memory_stats()
                with record_function(f"chip_smoke.call.{j}"):
                    ev[j][0].record()
                    run(modes[j])
                    ev[j][1].record()
                torch.cuda.synchronize()
                mem.append((torch.cuda.max_memory_allocated(), torch.cuda.memory_reserved()))
            elif j < 0:
                run(True)
            torch.cuda.synchronize()
    events = profile_events(torch, prof)
    windows = {int(e.name.rsplit(".", 1)[1]): (e.time_range.start, e.time_range.end) for e in events
               if e.name.startswith("chip_smoke.call.") and e.device_type != cuda}
    device = sorted((e.time_range.start, e.time_range.elapsed_us(), e.name) for e in events
                    if e.device_type == cuda and not getattr(e, "is_user_annotation", False)
                    and e.name != DEVICE_MS_MARK and not e.name.startswith("chip_smoke."))
    at = [i for i, (_, _, name) in enumerate(device) if "spin_kernel" in name][-(len(modes) + 1):]
    if len(at) != len(modes) + 1 or len(windows) != len(modes):
        print(f"graphs: {label}: the profile lost calls ({len(at)} markers, {len(windows)} windows)")
        return None
    host = [e for e in events if e.device_type != cuda]
    rows = []
    for j, g in enumerate(modes):
        lo, hi = windows[j]
        here = [e for e in host if lo <= e.time_range.start <= hi]
        mine = [e.name for e in here]
        dev = device[at[j] + 1:at[j + 1]]
        rows.append(dict(
            graphs=g, launches=sum(n in HOST_LAUNCHES for n in mine),
            in_copies=launches_inside(here, ("aten::copy_", "aten::_foreach_copy_")),
            graph_launches=mine.count("cudaGraphLaunch"),
            memcpys=sum(n.startswith("cudaMemcpy") for n in mine), fills=mine.count("aten::fill_"),
            copies=mine.count("aten::copy_"), foreach=mine.count("aten::_foreach_copy_"),
            ms=ev[j][0].elapsed_time(ev[j][1]), busy=sum(us for _, us, _ in dev) / 1e3,
            casts=sum(us for _, us, n in dev if "direct_copy_kernel" in n) / 1e3,
            memcpy_ms=sum(us for _, us, n in dev if n.lower().startswith("memcpy")) / 1e3,
            peak=mem[j][0], reserved=mem[j][1],
            kernels={n for _, _, n in dev if not n.lower().startswith(("memcpy", "memset"))},
            port=Counter(n for _, _, n in dev if port_symbol(n))))
    return rows


def launches_inside(events, ops):
    """How many of ``events``' host kernel launches start inside an event
    named in ``ops`` (the launches those ops made)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events if e.name in ops)
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    starts = [a for a, _ in merged]
    n = 0
    for e in events:
        if e.name in HOST_LAUNCHES:
            i = bisect.bisect_right(starts, e.time_range.start) - 1
            n += i >= 0 and e.time_range.start <= merged[i][1]
    return n


def graph_vs_eager(torch, label, call, want, pairs=GRAPH_PAIRS):
    """Graph against eager in ``pairs`` alternating pairs (G E, E G, ...)
    after one untimed graph call: wall per call by the host clock without
    the profiler, then the same order in one profile (:func:`call_profile`).
    Prints the medians and checks that a replay launches no kernel from the
    host apart from its input and output copies, the fills of
    ``CUDAGraph.replay``'s generator prologue and one graph launch, runs the
    same kernels as the eager call (and those copies and fills), and runs
    each of the port's kernels as often as the eager call: each
    wrapper's launches, measured from the device's kernel names
    (:func:`device_launches`), equal ``want`` in every replay and every eager
    call -> the replays' measured launches."""

    def run(graphs):
        with graph_mode(graphs):
            call()

    modes = [g for i in range(pairs) for g in ((True, False) if i % 2 == 0 else (False, True))]
    walls = {True: [], False: []}
    run(True)  # a path not captured yet captures here, outside the timed calls
    for g in modes:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(g)
        torch.cuda.synchronize()
        walls[g].append(1e3 * (time.perf_counter() - t0))
    rows = call_profile(torch, label, modes, run)
    out = {}
    for g in (True, False):
        mine = [r for r in rows if r["graphs"] == g]
        med = {k: statistics.median(r[k] for r in mine)
               for k in ("launches", "in_copies", "graph_launches", "memcpys", "fills", "copies",
                         "foreach", "ms", "busy", "casts", "memcpy_ms", "peak", "reserved")}
        med["wall"] = statistics.median(walls[g])
        med["idle"] = 1.0 - med["busy"] / med["ms"] if med["ms"] else math.nan
        med["kernels"] = set().union(*(r["kernels"] for r in mine))
        out[g] = med
        print(f"graphs: {label} {'graph' if g else 'eager'} (median of {len(mine)}): wall "
              f"{med['wall']:.3f} ms unprofiled, {med['ms']:.3f} ms profiled; device busy "
              f"{med['busy']:.3f} ms (idle {100 * med['idle']:.1f}%; casts and copies by kernel "
              f"{med['casts']:.3f} ms, memcpy {med['memcpy_ms']:.3f} ms); host: {med['launches']:.0f} "
              f"kernel launch calls ({med['in_copies']:.0f} inside copy ops), "
              f"{med['graph_launches']:.0f} graph launches, {med['memcpys']:.0f} memcpy calls, "
              f"{med['copies']:.0f} copy ops, {med['foreach']:.0f} multi-tensor copy ops, "
              f"{med['fills']:.0f} fill ops; peak allocated "
              f"{med['peak'] / 2 ** 30:.2f} GiB, reserved {med['reserved'] / 2 ** 30:.2f} GiB; "
              f"walls {[round(w, 3) for w in walls[g]]}")
    g, e = out[True], out[False]
    print(f"graphs: {label}: graph / eager wall {g['wall'] / e['wall']:.3f}, busy "
          f"{g['busy'] / e['busy']:.3f}")
    for r in rows:
        if r["graphs"]:
            check(r["graph_launches"] == 1 and r["launches"] <= r["fills"] + r["in_copies"],
                  f"{label}: a replay made {r['launches']} kernel launch calls for {r['fills']} "
                  f"generator fills, {r['in_copies']} inside its input and output copies and "
                  f"{r['graph_launches']} graph launches")
    missing, extra = e["kernels"] - g["kernels"], g["kernels"] - e["kernels"]
    print(f"graphs: {label}: {len(g['kernels'])} kernel names in the replays, {len(e['kernels'])} "
          f"eager; only eager {sorted(missing)[:4]}, only graph {sorted(extra)[:4]}")
    check(g["busy"] > 0.0, f"{label}: the profiler recorded no device time for a replay")
    # the replay's own: the generator fills and the multi-tensor input copies
    check(not missing and all("fill" in n.lower() or ("multi_tensor_apply" in n and "Copy<" in n)
                              for n in extra),
          f"{label}: the replay's kernels differ from the eager call's")
    measured = [(r["graphs"], device_launches(r["port"])) for r in rows]
    replay = next(m for g, m in measured if g)
    print(f"graphs: {label}: launches measured on the device per replay {counts_text(replay)}, "
          f"per eager call {counts_text(next(m for g, m in measured if not g))}; "
          f"{sum(rows[0]['port'].values())} port kernel launches per call")
    check(all(m == want for _, m in measured),
          f"{label}: device-measured launches {[m for _, m in measured]}, expected {want}")
    check(all(r["port"] == rows[0]["port"] for r in rows),
          f"{label}: the port's kernels by name differ between calls")
    return replay


def replay_launches(torch, label, call, want):
    """One untimed graph call (a capture where the path has none yet), then
    one profiled replay: it launches one graph and each of the port's kernels
    ``want`` times, by the device's kernel names; prints its host side ->
    those launches."""
    def run(graphs):
        with graph_mode(graphs):
            call()

    run(True)
    (row,) = call_profile(torch, label, [True], run)
    replay = device_launches(row["port"])
    print(f"graphs: {label}: one replay, {row['ms']:.3f} ms profiled, device busy {row['busy']:.3f} ms; "
          f"host: {row['launches']} kernel launch calls ({row['in_copies']} inside copy ops), "
          f"{row['graph_launches']} graph launch(es), {row['memcpys']} memcpy calls, {row['fills']} "
          f"fill ops; launches measured on the device {counts_text(replay)}")
    check(row["graph_launches"] == 1 and replay == want,
          f"{label}: a replay made {row['graph_launches']} graph launches and device launches {replay}, "
          f"expected {want}")
    return replay


def graph_path(torch, label, first, call, want, n=2):
    """A path through the compiled layer: ``first()`` makes its first call's
    result from the start state, ``call(prev)`` one call (``prev`` None: from
    the start state).  Eager twice and graph once, ``n`` chained calls each;
    the launch counts around one replay (returned); the captures it made."""
    from feddat_tpu_torch.train import compiled

    eager, eager_counts = run_calls(torch, call, False, n)
    eager2, _ = run_calls(torch, call, False, n)
    cap0 = compiled.STATS["captures"]
    graph, first_counts = run_calls(torch, call, True, n)
    captures = compiled.STATS["captures"] - cap0
    reset_counts()
    rep0 = compiled.STATS["replays"]
    first()
    torch.cuda.synchronize()
    replay = read_counts()
    replays = compiled.STATS["replays"] - rep0
    print(f"graphs: {label}: {captures} capture(s); wrapper counts per eager call "
          f"{counts_text(eager_counts)}, per replay {counts_text(replay)} ({replays} replay), first graph call "
          f"{counts_text(first_counts)}; expected {counts_text(want)}")
    check(captures >= 1 and replays == 1, f"{label}: {captures} captures, {replays} replays")
    check(eager_counts == replay == first_counts == want,
          f"{label}: launches eager {eager_counts}, replay {replay}, expected {want}")
    graph_agreement(torch, label, graph, eager, eager2)
    return replay


def counts_text(counts):
    return ", ".join(f"{k} {v}" for k, v in counts.items() if v) or "none"


def vilt_step_path(torch, label, seed, attn_impl, fused, want):
    from feddat_tpu_torch.train import dat

    model = build_trainer_model(torch, seed, attn_impl)
    params = {k: v.detach() for k, v in model.state_dict().items()}
    batch = to_cuda_batch(torch, train_client(TRAIN_CLIENTS[0], TB, 0, seed))
    step, part, opt = make_steps(model, params, fused)
    state0 = dat.init_train_state(params, part, opt, torch.Generator().manual_seed(seed))
    graph_path(torch, label, lambda: step(state0, batch),
               lambda prev: step(prev[0] if prev else state0, batch), want)
    launches = graph_vs_eager(torch, label, lambda: step(state0, batch), want)
    return dict(model=model, params=params, batch=batch, launches=launches)


def to_cuda_batch(torch, client):
    from feddat_tpu_torch.train.forwards import to_device

    return to_device(next(client.train_batches(0)), torch.device("cuda"))


def gate_checks(torch, seed):
    """The routing gate on the card: #4's padded bottleneck as the wrapper
    pads it against the library's own; a "layer" DAT step at adapter
    bottleneck 96 (reduction 8) goes through #1/#4 (24 launches each, #3
    none) and holds the 2x-bf16 rule against the plain path.  Then the path
    past the first designs' limits, S=769 on #1/#3 and bottleneck 192 on #2
    (:func:`long_canvas_path`)."""
    import ctypes

    from feddat_tpu_torch.configs.core import OptimizerConfig, PEFTMode
    from feddat_tpu_torch.models import create_model
    from feddat_tpu_torch.models.vilt import TaskHeadSpec
    from feddat_tpu_torch.ops import layer_block as lb
    from feddat_tpu_torch.ops._build import load
    from feddat_tpu_torch.train import dat
    from feddat_tpu_torch.train.forwards import make_vilt_fused_parts

    fn = load("layer_block").layer_block_padded_bottleneck
    fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_int
    pads = {(r, f32): (lb.padded_bottleneck(r, f32), fn(r, int(f32)))
            for r in (1, 5, 16, 24, 48, 64, 80, 96, 100, 192, 384) for f32 in (False, True)}
    print(f"gates: #4's padded bottleneck (wrapper, library) by (R, fp32): {pads}")
    check(all(a == b for a, b in pads.values()), "the wrapper pads the bottleneck otherwise than #4")

    def r96(attn_impl, dtype="bfloat16", state=None):
        model, cfg = create_model("vilt", {k: TaskHeadSpec(num_labels=NUM_LABELS) for k in TRAIN_CLIENTS},
                                  PEFTMode.DAT, 8, dtype, image_size=TCANVAS, attn_impl=attn_impl,
                                  seed=seed)
        if state is not None:
            model.load_state_dict(state)
        return model

    model = r96("layer")
    layers = model.config.num_layers
    check(model.vilt.layers[0].adapter.bottleneck == 96, "the reduction-8 model's bottleneck is not 96")
    params = {k: v.detach() for k, v in model.state_dict().items()}
    batch = to_cuda_batch(torch, train_client(TRAIN_CLIENTS[0], TB, 0, seed))
    part = dat.Partitioner(params, TRAIN_CLIENTS[0], PEFTMode.DAT)
    opt = OptimizerConfig()
    state0 = dat.init_train_state(params, part, opt, torch.Generator().manual_seed(seed))

    def step_of(m):
        return dat.make_dat_train_step_fused(*make_vilt_fused_parts(m, TRAIN_CLIENTS[0]), part, opt, 100)

    step = step_of(model)
    reset_counts()
    _, kernel_m = step(state0, batch)
    torch.cuda.synchronize()
    launches = read_counts()
    want = {**NO_LAUNCHES, "attn_block": 2 * layers, "layer_block_bwd": 2 * layers}
    print(f"gates: fused DAT step, attn_impl='layer', bottleneck 96, B={TB} S={TS}: launches "
          f"{counts_text(launches)} (expected {counts_text(want)}: #4 at every layer, #3 none)")
    check(launches == want, f"bottleneck-96 layer step launches {launches}, expected {want}")
    sd = model.state_dict()
    del step, model
    with graph_mode(False):
        before = read_counts()
        plain_m = step_of(r96("auto", state=sd))(state0, batch)[1]
        exact_m = step_of(r96("auto", "float32", state=sd))(state0, batch)[1]
        torch.cuda.synchronize()
        check(read_counts() == before, "the plain path launched a kernel")
    grad_agreement(torch, "fused step, bottleneck 96, layer route", kernel_m, plain_m, exact_m)
    del kernel_m, plain_m, exact_m, params, state0, sd
    torch.cuda.empty_cache()

    long_canvas_path(torch, seed)


# Past both of the first designs' limits (#1/#3's S <= 768, #2's R <= 128):
# full-width ViLT-B/32 DAT at reduction 4 (bottleneck 192), the fused
# ensemble adapter, bf16, "block" with fuse_ln, on a canvas of 832 x 896
# (26 x 28 patches: S = 40 + 728 + 1 = 769), B=16.
LONG_CANVAS = (832, 896)


def long_canvas_path(torch, seed):
    """Two standard DAT steps through #1, #3 and #2 (the step's two ensemble
    passes run the fused adapter: #1 36, #3 22, #2 24 per step), the first
    held by the 2x-bf16 rule against the plain path in bf16 and fp32; then
    ViltVqaPredictor's ensemble forward (#1 12, #2 12) by the serving rule
    against the plain route."""
    from feddat_tpu_torch.configs.core import OptimizerConfig, PEFTMode
    from feddat_tpu_torch.data.synthetic import SyntheticVQAClient
    from feddat_tpu_torch.models import create_model
    from feddat_tpu_torch.models.vilt import TaskHeadSpec
    from feddat_tpu_torch.train import dat
    from feddat_tpu_torch.train.forwards import make_vilt_forward, to_device

    t0 = time.perf_counter()
    s_long = TEXT_LEN + (LONG_CANVAS[0] // 32) * (LONG_CANVAS[1] // 32) + 1
    check(s_long == 769, f"the long canvas gives S={s_long}")

    def model_of(attn_impl, fused, dtype="bfloat16", state=None):
        model, cfg = create_model("vilt", {k: TaskHeadSpec(num_labels=NUM_LABELS) for k in TRAIN_CLIENTS},
                                  PEFTMode.DAT, 4, dtype, image_size=LONG_CANVAS, attn_impl=attn_impl,
                                  adapter_fused=fused, seed=seed if state is None else None)
        if state is not None:
            model.load_state_dict(state)
        return model, cfg

    model, cfg = model_of("block", True)
    layers = cfg.num_layers
    check(cfg.fuse_ln and cfg.adapter.fused and model.vilt.layers[0].adapter.bottleneck == 192,
          f"unexpected long-canvas model {cfg}")
    client = SyntheticVQAClient("c0", num_train=2 * B, num_eval=0, num_labels=NUM_LABELS, vocab_size=30522,
                                text_len=TEXT_LEN, image_size=LONG_CANVAS, batch_size=B, val_batch_size=B,
                                seed=seed)
    batches = [to_device(bt, torch.device("cuda")) for bt in client.train_batches(0)]
    check(len(batches) == 2 and tuple(batches[0]["pixel_values"].shape[1:3]) == LONG_CANVAS,
          "the long-canvas client's batches")
    params = {k: v.detach() for k, v in model.state_dict().items()}
    part = dat.Partitioner(params, TRAIN_CLIENTS[0], PEFTMode.DAT)
    opt = OptimizerConfig()
    state0 = dat.init_train_state(params, part, opt, torch.Generator().manual_seed(seed))

    def step_of(m):
        return dat.make_dat_train_step(make_vilt_forward(m, TRAIN_CLIENTS[0]), part, opt, 100)

    want = {**NO_LAUNCHES, "attn_block": 3 * layers, "attn_block_bwd": 2 * (layers - 1),
            "adapter_fused": 2 * layers}
    step = step_of(model)
    state = state0
    for i, batch in enumerate(batches):
        reset_counts()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        launches = read_counts()
        print(f"gates: long canvas, standard DAT step {i + 1}, attn_impl='block', fused ensemble, bottleneck "
              f"192, B={B} S={s_long}: launches {counts_text(launches)} (expected {counts_text(want)}); "
              f"loss {float(m['loss']):.4f}, loss_shared {float(m['loss_shared']):.4f}")
        check(launches == want, f"long-canvas step launches {launches}, expected {want}")
        check(math.isfinite(float(m["loss"])) and math.isfinite(float(m["loss_shared"])),
              "long-canvas step: non-finite loss")
        if i == 0:  # the first step's gradients, before the next call can reuse its buffers
            sd = model.state_dict()
            with graph_mode(False):
                before = read_counts()
                plain_m = step_of(model_of("auto", False, state=sd)[0])(state0, batch)[1]
                exact_m = step_of(model_of("auto", False, "float32", state=sd)[0])(state0, batch)[1]
                torch.cuda.synchronize()
                check(read_counts() == before, "the plain path launched a kernel")
            grad_agreement(torch, f"standard step, long canvas S={s_long}, bottleneck 192", m, plain_m,
                           exact_m)
            del plain_m, exact_m
            torch.cuda.empty_cache()
    del step, model, state, m, state0, params
    torch.cuda.empty_cache()

    pred = build_predictor(torch, seed, "block", True, canvas=LONG_CANVAS, reduction=4)
    check(pred.model.vilt.layers[0].adapter.bottleneck == 192, "the long-canvas predictor's bottleneck")
    imgs, qs = synthetic_requests(B, seed)
    batch = pred._preprocess(imgs, qs)
    reset_counts()
    probs_kernel = pred.forward(batch)
    torch.cuda.synchronize()
    launches = read_counts()
    want = {**NO_LAUNCHES, "attn_block": layers, "adapter_fused": layers}
    print(f"gates: long canvas, ViltVqaPredictor.forward (ensemble), B={B} S={s_long}: launches "
          f"{counts_text(launches)} (expected {counts_text(want)})")
    check(launches == want, f"long-canvas forward launches {launches}, expected {want}")
    plain = build_predictor(torch, seed, "auto", False, state=pred.model.state_dict(), canvas=LONG_CANVAS,
                            reduction=4)
    with graph_mode(False):
        probs_plain = plain.forward(batch)
    check(read_counts() == launches, "the plain path launched a kernel")
    serving_agreement(f"gates: long canvas S={s_long}:", probs_kernel, probs_plain, B)
    del pred, plain, probs_kernel, probs_plain
    torch.cuda.empty_cache()
    print(f"gates: long-canvas path took {time.perf_counter() - t0:.1f} s")


def federated_rounds(torch, label, make_trainer, captures, programs):
    """One round of a FederatedTrainer and evaluate_dat, eager and then with
    graphs: the graph round shares ``programs`` programs and captures
    ``captures`` graphs, launches what the eager round launches, and gives
    bitwise equal scores and server adapters; prints the times and the peak
    reserved memory of each."""
    from feddat_tpu_torch.train import compiled

    rounds = {}
    for graphs in (False, True):
        trainer = make_trainer()
        with graph_mode(graphs):
            cap0 = compiled.STATS["captures"]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            trainer.run_round(0)
            torch.cuda.synchronize()
            round_s = time.perf_counter() - t0
            round_launches = read_counts()
            entry = trainer.evaluate_round(0)
            made = compiled.STATS["captures"] - cap0
        shared = len(trainer._programs)
        rounds[graphs] = dict(scores=entry["scores"], captures=made, launches=round_launches,
                              programs=shared,
                              server={k: v for k, v in trainer.server_params.items() if "adapter" in k})
        print(f"graphs: FederatedTrainer, {label}, {'graphs' if graphs else 'eager'}: round 0 "
              f"{round_s:.3f} s (captures included); {made} captures, {shared} programs; launches "
              f"in the round {counts_text(round_launches)}; evaluate_dat {entry['scores']}; peak "
              f"reserved {torch.cuda.max_memory_reserved() / 2 ** 30:.2f} GiB")
        del trainer
        torch.cuda.empty_cache()
    g, e = rounds[True], rounds[False]
    check(g["captures"] == captures and g["programs"] == programs,
          f"{label}: {g['captures']} captures and {g['programs']} programs, expected {captures} "
          f"and {programs}")
    check(g["launches"] == e["launches"], f"{label}: round launches graph {g['launches']}, eager {e['launches']}")
    check(g["scores"] == e["scores"], f"{label}: evaluate_dat graph {g['scores']}, eager {e['scores']}")
    bad = [k for k in e["server"] if not torch.equal(g["server"][k], e["server"][k])]
    print(f"graphs: FederatedTrainer, {label}, graphs vs eager after the round: {len(bad)} of "
          f"{len(e['server'])} adapter tensors differ (bitwise rule)")
    check(not bad, f"{label}: the graph round's server adapters differ from the eager round's: {bad[:3]}")


def phase_graphs(torch, seed):
    """Each path of the compiled layer as users call it (see the comment
    above GRAPH_PAIRS), the FederatedTrainer's shared programs, and the
    routing gates -> launches per replay, for the JSON line."""
    from feddat_tpu_torch.configs.core import FederatedConfig, OptimizerConfig, PEFTMode, TrainConfig
    from feddat_tpu_torch.data.synthetic import SyntheticAlbefClient
    from feddat_tpu_torch.federated.engine import FederatedTrainer
    from feddat_tpu_torch.train import compiled, dat
    from feddat_tpu_torch.train.evaluation import make_albef_eval_step, make_eval_step
    from feddat_tpu_torch.train.trainers import resolve_trainer

    t_phase = time.perf_counter()
    launches = {}

    # 1. the fused DAT step, ViLT, attn_impl='layer': #1 and #4
    p = vilt_step_path(torch, "ViLT fused DAT step (layer)", seed, "layer", True,
                       {**NO_LAUNCHES, "attn_block": 24, "layer_block_bwd": 24})
    launches.update(attn_block=p["launches"]["attn_block"],
                    layer_block_bwd=p["launches"]["layer_block_bwd"])

    # 5a. the ViLT eval step on the same model, each DAT mode (evaluate_dat)
    ev = make_eval_step(p["model"], TRAIN_CLIENTS[0])
    for mode in ("ensemble", "adapter_0", "adapter_1"):
        def call(prev, mode=mode):
            return ev(p["params"], p["batch"], adapter_mode=mode)
        graph_path(torch, f"ViLT eval step ({mode})", lambda: call(None), call,
                   {**NO_LAUNCHES, "attn_block": 12})
    graph_vs_eager(torch, "ViLT eval step (ensemble)",
                   lambda: ev(p["params"], p["batch"], adapter_mode="ensemble"),
                   {**NO_LAUNCHES, "attn_block": 12})
    del p, ev
    torch.cuda.empty_cache()

    # 4. the standard DAT step, attn_impl='block': #1 and #3
    p = vilt_step_path(torch, "ViLT standard DAT step (block)", seed, "block", False,
                       {**NO_LAUNCHES, "attn_block": 36, "attn_block_bwd": 22})
    launches["attn_block_bwd"] = p["launches"]["attn_block_bwd"]
    del p
    torch.cuda.empty_cache()

    # 2. the LoRA step, attn_impl='fused': #5 and #6
    model = peft_model(torch, "lora", seed, "fused")
    params = {k: v.detach() for k, v in model.state_dict().items()}
    batch = to_cuda_batch(torch, peft_client(TRAIN_CLIENTS[0], TB, 0, seed))
    step, part, opt = peft_step(model, "lora", params)
    state0 = dat.init_train_state(params, part, opt, torch.Generator().manual_seed(seed))
    want = {**NO_LAUNCHES, "fused_attention": 12, "fused_attention_bwd": 12}
    graph_path(torch, "LoRA step (fused)", lambda: step(state0, batch),
               lambda prev: step(prev[0] if prev else state0, batch), want)
    replay = graph_vs_eager(torch, "LoRA step (fused)", lambda: step(state0, batch), want)
    launches.update(fused_attention=replay["fused_attention"],
                    fused_attention_bwd=replay["fused_attention_bwd"])
    del model, params, batch, step, state0
    torch.cuda.empty_cache()

    # 6. ViltVqaPredictor.forward, one graph per bucket: #1 and #2; the second
    # request batch is replayed from rewritten input buffers (#2's TMA maps
    # hold the capture's addresses)
    pred = build_predictor(torch, seed, "block", True)
    imgs, qs = synthetic_requests(2 * B, seed)
    batches = [pred._preprocess(imgs[:B], qs[:B]), pred._preprocess(imgs[B:], qs[B:])]
    want = {**NO_LAUNCHES, "attn_block": 12, "adapter_fused": 12}
    graph_path(torch, "ViLT serving forward (B=16, two request batches)",
               lambda: pred.forward(batches[0]),
               lambda prev: torch.from_numpy(pred.forward(batches[0 if prev is None else 1])),
               want, n=2)
    single = pred.predict(imgs[:1], qs[:1], top_k=5)
    with graph_mode(False):
        single_eager = pred.predict(imgs[:1], qs[:1], top_k=5)
    print(f"graphs: ViLT predict, the B=1 bucket: graph {single[0][:2]}, eager {single_eager[0][:2]}")
    check(single == single_eager, "the B=1 bucket's replay differs from the eager forward")
    replay = graph_vs_eager(torch, "ViLT serving forward (B=16)", lambda: pred.forward(batches[1]),
                            want)
    launches["adapter_fused"] = replay["adapter_fused"]
    del pred, batches
    torch.cuda.empty_cache()

    # 7. AlbefVqaPredictor.rank (rank_answer, k=64), one graph per bucket: #7
    pred = albef_predictor(torch, seed, "flash")
    imgs, qs = albef_requests(2 * AB, seed)
    batches = [pred._preprocess(imgs[:AB], qs[:AB]), pred._preprocess(imgs[AB:], qs[AB:])]
    want = {**NO_LAUNCHES, "flash_attention": 54}
    graph_path(torch, "ALBEF rank_answer (B=16, k=64)", lambda: pred.rank(batches[0]),
               lambda prev: tuple(torch.from_numpy(a) for a in
                                  pred.rank(batches[0 if prev is None else 1])), want, n=2)
    replay = graph_vs_eager(torch, "ALBEF rank_answer (B=16, k=64)", lambda: pred.rank(batches[0]),
                            want)
    launches["flash_attention"] = replay["flash_attention"]
    del pred, batches
    torch.cuda.empty_cache()

    # 3. the fused ALBEF step, dropout 0.1 live, attn_impl='flash': #7, #8, #9
    model = albef_train_model(torch, seed, "flash")
    params = {n: t.detach() for n, t in model.state_dict().items()}
    batch = albef_train_batch(torch, ATB, seed)
    step, state0 = albef_fused_step(torch, model, params, seed)
    vit = model.cfg.vision_layers
    want = {**NO_LAUNCHES, "flash_attention": 2 * vit, "flash_attention_bwd_dq": 2 * (vit - 1),
            "flash_attention_bwd_dkv": 2 * (vit - 1)}
    graph_path(torch, "ALBEF fused DAT step (flash, dropout live, B=48x4)",
               lambda: step(state0, batch),
               lambda prev: step(prev[0] if prev else state0, batch), want)
    _, m1 = step(state0, batch)
    _, m2 = step(state0, batch)
    _, m3 = step(state0.replace(rng=torch.Generator().manual_seed(seed + 1)), batch)
    same = [float(m1[k]) == float(m2[k]) for k in ("loss", "loss_shared")]
    moved = [abs(float(m3[k]) - float(m1[k])) for k in ("loss", "loss_shared")]
    print(f"graphs: ALBEF replays from one state: losses equal {same}; from generator seed "
          f"{seed + 1}: losses move by {moved[0]:.3e}, {moved[1]:.3e}")
    check(all(same) and min(moved) > 0.0, "replayed dropout masks are not a function of the seed")
    del m1, m2, m3
    replay = graph_vs_eager(torch, "ALBEF fused DAT step (B=48x4)", lambda: step(state0, batch),
                            want)
    launches.update({k: replay[k] for k in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")})
    del step, state0

    # 5b. the ALBEF eval step (rank_answer over a client's bank), each DAT mode
    client = SyntheticAlbefClient("c0", num_train=ATB, num_eval=ATB, num_answers=len(ALBEF_ANSWERS),
                                  vocab_size=30522, question_len=LQ, answer_len=LA,
                                  max_answers_per_q=ANS_PER_Q, image_size=(ARES, ARES),
                                  batch_size=ATB, val_batch_size=ATB, seed=seed + 1)
    aev = make_albef_eval_step(model, client.answer_ids, client.answer_mask, k=ALBEF_K)
    eval_batch = next(iter(client.eval_batches()))
    for mode in ("ensemble", "adapter_0"):
        def acall(prev, mode=mode):
            return aev(params, eval_batch, adapter_mode=mode)
        graph_path(torch, f"ALBEF eval step ({mode}, B={ATB})", lambda: acall(None), acall,
                   {**NO_LAUNCHES, "flash_attention": 54})
    graph_vs_eager(
        torch, f"ALBEF eval step (B={ATB})", lambda: aev(params, eval_batch, adapter_mode="ensemble"),
        {**NO_LAUNCHES, "flash_attention": 54})
    del aev
    torch.cuda.empty_cache()

    # 8. FederatedTrainer: two ALBEF clients share one train program and one
    # eval program; a round and evaluate_dat, eager against graphs
    clients = {k: SyntheticAlbefClient(k, num_train=2 * ATB, num_eval=ATB, num_answers=len(ALBEF_ANSWERS),
                                       vocab_size=30522, question_len=LQ, answer_len=LA,
                                       max_answers_per_q=ANS_PER_Q, image_size=(ARES, ARES),
                                       batch_size=ATB, val_batch_size=ATB, seed=seed + 1 + i)
               for i, k in enumerate(TRAIN_CLIENTS)}
    hooks = resolve_trainer("albef_no_distill", "vqa", rank_k=ALBEF_K, answer_banks={
        k: (c.answer_ids, c.answer_mask) for k, c in clients.items()})
    tcfg = TrainConfig(encoder_name="albef_no_distill", peft_mode=PEFTMode.DAT,
                       optimizer=OptimizerConfig(),
                       federated=FederatedConfig(comm_rounds=2, local_epochs=1, eval_every=1),
                       num_epochs=1, seed=seed)
    federated_rounds(torch, "2 ALBEF clients x 2 fused steps", lambda: FederatedTrainer(
        model, params, clients, tcfg, make_forward=hooks.make_forward, make_eval=hooks.make_eval,
        use_fused_dat=True), captures=1 + 3, programs=2)
    del model, params, batch, clients
    torch.cuda.empty_cache()

    # 8b. the same for phase train's ViLT round, the main DAT path: each
    # client has its task head, so its own train and eval programs
    model = build_trainer_model(torch, seed, "layer")
    params = {k: v.detach() for k, v in model.state_dict().items()}
    clients = {k: train_client(k, 2 * TB, TB, seed + 1 + i) for i, k in enumerate(TRAIN_CLIENTS)}
    vcfg = TrainConfig(peft_mode=PEFTMode.DAT, optimizer=OptimizerConfig(),
                       federated=FederatedConfig(comm_rounds=2, local_epochs=1, eval_every=1),
                       num_epochs=1, seed=seed)
    federated_rounds(torch, "2 ViLT clients x 2 fused steps", lambda: FederatedTrainer(
        model, params, clients, vcfg, use_fused_dat=True), captures=2 * (1 + 3), programs=4)
    del model, params, clients
    torch.cuda.empty_cache()

    gate_checks(torch, seed)
    print(f"graphs: phase took {time.perf_counter() - t_phase:.1f} s; compiled.STATS {compiled.STATS}")
    return launches


# bench.py:192-229's accelerator flags (scripts/train_albef_tpu_tuned.sh:30-34):
# create_model(..., attn_impl="layer") routes the ViT alone through #1/#4
TUNED_FLAGS = dict(remat=True, remat_policy="block_save_nox", text_remat_policy="names",
                   attention_logits_dtype="bfloat16")
SECOND_B = 16  # the second path's batch (the JAX package's round-3 "block" route)
SPEED_ROUNDS = 1
STEP_GROUPS = {"port kernels": PORT_KERNELS, "cuBLAS GEMM": ("xmma", "nvjet", "cutlass"),
               "casts and copies": ("direct_copy_kernel",)}


def tuned_flags_check(model, vision):
    cfg = model.cfg
    check(cfg.remat and cfg.remat_policy == "block_save_nox" and cfg.text_remat is None
          and cfg.text_remat_policy == "names" and cfg.fuse_ln and cfg.attention_logits_dtype == "bfloat16"
          and model.visual_encoder.attn_impl == vision
          and model.text_encoder.encoder.text_layers[0].attention.attn_impl == "auto"
          and model.text_encoder.encoder.remat and model.text_decoder.bert.encoder.remat,
          f"unexpected tuned ALBEF configuration {cfg}")


def same_tensors(torch, label, a, b):
    """Bitwise comparison of two steps' tensors by name (step_tensors)."""
    check(a.keys() == b.keys(), f"{label}: the two steps give different tensors")
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    print(f"albef_tuned: {label}: {len(a)} tensors (losses, four gradient sets, adapters and moments), "
          f"{len(bad)} differ{'' if not bad else ' e.g. ' + bad[0]}")
    return bad


def tensor_gib(tensors):
    """GiB of the distinct storages under ``tensors``."""
    seen = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes() for t in tensors}
    return sum(seen.values()) / 2 ** 30


def path_speed(torch, paths, batch, seed, weights, rounds=SPEED_ROUNDS):
    """Samples/s and peak memory of fused ALBEF steps with graphs on (the
    users' default), by :func:`alternating_speed`.  Every path's model
    stays on the card, so a path's peak is its own: the peak above what was
    resident at its start, plus the ``weights`` GiB of the one weight set
    its step reads.  -> {path: (samples/s median, samples, own peak
    reserved GiB, own peak allocated GiB)}."""
    makers = {name: (lambda m=model, p=params: (*albef_fused_step(torch, m, p, seed), batch))
              for name, (model, params) in paths.items()}
    speed = alternating_speed(torch, makers, ATB, rounds)
    return {name: (rate, samples, reserved + weights, allocated + weights)
            for name, (rate, samples, reserved, allocated) in speed.items()}


def phase_albef_tuned(torch, seed):
    """The JAX package's tuned ALBEF configuration (bench.py:192-229): the ViT
    on the whole-layer kernels (#1 forward, #4 backward) at S=577 without
    remat, the BERT towers on the composable path with "names" remat, bf16
    logits, fused LN; the fused DAT step at B=48 x 4 answers, dropout 0.1
    live.  Then the "block" route with block_save_nox remat at B=16 (#1, #3).
    -> the kernels' launches per replayed step on these paths."""
    t_phase = time.perf_counter()
    batch = albef_train_batch(torch, ATB, seed)
    model = albef_train_model(torch, seed, "layer", **TUNED_FLAGS)
    tuned_flags_check(model, "layer")
    sd = model.state_dict()
    params = {n: t.detach() for n, t in sd.items()}
    vit = model.cfg.vision_layers
    want = {**NO_LAUNCHES, "attn_block": 2 * vit, "layer_block_bwd": 2 * vit}

    # (a) dropout off: the tuned step against the plain path by the 2x-bf16
    # rule (plain bf16 with the same bf16 logits; the exact one in fp32)
    with graph_mode(False):
        off = albef_train_model(torch, seed, "layer", dropout=False, state=sd, **TUNED_FLAGS)
        step_off, state0 = albef_fused_step(torch, off, params, seed)
        torch.cuda.synchronize()
        reset_counts()
        _, kernel_m = step_off(state0, batch)
        torch.cuda.synchronize()
        off_counts = read_counts()
        print(f"albef_tuned: fused DAT step, dropout off, B={ATB}: launches {counts_text(off_counts)} "
              f"(expected {counts_text(want)}: #1 and #4 once per ViT layer per encoder pass)")
        check(off_counts == want, f"albef_tuned dropout-off launches {off_counts}, expected {want}")
        del off, step_off
        plain = albef_train_model(torch, seed, "auto", dropout=False, state=sd,
                                  attention_logits_dtype="bfloat16")
        plain_m = albef_fused_step(torch, plain, params, seed)[0](state0, batch)[1]
        del plain
        torch.cuda.empty_cache()
        exact = albef_train_model(torch, seed, "auto", "float32", dropout=False, state=sd)
        exact_m = albef_fused_step(torch, exact, params, seed)[0](state0, batch)[1]
        del exact
        grad_agreement(torch, f"albef tuned fused step, dropout off, B={ATB}", kernel_m, plain_m, exact_m)
        del kernel_m, plain_m, exact_m
    torch.cuda.empty_cache()

    # (b) remat on ("names", then "full" on the BERT towers) against remat
    # off, dropout live, the same generators (eager): equal losses,
    # gradients, adapters and moments; each step's peak allocated above what
    # was resident at its start
    nor = albef_train_model(torch, seed, "layer", state=sd, **{**TUNED_FLAGS, "remat": False})
    full = albef_train_model(torch, seed, "layer", state=sd,
                             **{**TUNED_FLAGS, "text_remat_policy": "full"})
    runs, peaks = {}, {}
    with graph_mode(False):
        for label, m_ in (("names", model), ("full", full), ("no remat", nor)):
            step_, state0 = albef_fused_step(torch, m_, params, seed)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            runs[label] = step_tensors(torch, step_(state0, batch), 0)
            torch.cuda.synchronize()
            peaks[label] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            del step_
    for label in ("names", "full"):
        bad = same_tensors(torch, f"remat ('{label}' on the BERT towers) against no remat, dropout "
                                  "live, one eager step from one state", runs[label], runs["no remat"])
        check(not bad, f"albef_tuned: '{label}' remat changes the step: {bad[:3]}")
    print("albef_tuned: eager step, dropout live, peak allocated above what was resident at its "
          "start: " + ", ".join(f"{k} {v:.3f} GiB" for k, v in peaks.items())
          + f"; 'names' saves {peaks['no remat'] - peaks['names']:.3f}, 'full' "
          f"{peaks['no remat'] - peaks['full']:.3f} GiB")
    del runs, full, nor
    torch.cuda.empty_cache()

    # (c) graphs: a replay bitwise an eager step (the chained replays of the
    # graphs phase's paths and of the "block" route below hold the state
    # threading), the launches per replay
    # from the wrappers and from the device; graph against eager
    step, state0 = albef_fused_step(torch, model, params, seed)
    label = f"ALBEF tuned fused DAT step (layer, remat, dropout live, B={ATB}x{ANS_PER_Q})"
    graph_path(torch, label, lambda: step(state0, batch),
               lambda prev: step(prev[0] if prev else state0, batch), want, n=1)
    replay = graph_vs_eager(torch, label, lambda: step(state0, batch), want)
    launches = {k: replay[k] for k in ("attn_block", "layer_block_bwd")}
    profile_device(torch, lambda: step(state0, batch), f"ALBEF tuned fused DAT step, replayed "
                   f"(B={ATB})", STEP_GROUPS)
    del step, state0
    torch.cuda.empty_cache()

    # (d) samples/s and peak memory: the tuned configuration and phase
    # albef_train's "flash" path, graphs on, in the same alternating rounds
    # (rates of more paths belong to the bench of ROADMAP item 7)
    flash = albef_train_model(torch, seed, "flash", state=sd)
    weights = tensor_gib(params.values())
    speed = path_speed(torch, {"tuned": (model, params), "flash": (flash, params)}, batch, seed,
                       weights)
    for name, (rate, samples, reserved, allocated) in speed.items():
        print(f"time albef_tuned: {name}: {rate:.1f} samples/s (fused DAT step B={ATB}x{ANS_PER_Q}, "
              f"dropout live, replayed graph; median of {len(samples)} samples of 2 steps, in "
              f"{SPEED_ROUNDS} round(s) with the other path: {samples}); own peak reserved {reserved:.2f} GiB, allocated "
              f"{allocated:.2f} GiB (capture included; one weight set, {weights:.2f} GiB, included)")
    del flash
    torch.cuda.empty_cache()
    tuned_round(torch, model, params, seed)
    del model, params
    torch.cuda.empty_cache()
    launches["attn_block_bwd"] = block_route_path(torch, seed)
    vit_kernel_times(torch, seed)
    print(f"albef_tuned: phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


def tuned_round(torch, model, params, seed):
    """(e) one FederatedTrainer round of two clients in the tuned
    configuration, one fused step each, and evaluate_dat, eager against
    graphs."""
    from feddat_tpu_torch.configs.core import FederatedConfig, OptimizerConfig, PEFTMode, TrainConfig
    from feddat_tpu_torch.data.synthetic import SyntheticAlbefClient
    from feddat_tpu_torch.federated.engine import FederatedTrainer
    from feddat_tpu_torch.train.trainers import resolve_trainer

    clients = {k: SyntheticAlbefClient(k, num_train=ATB, num_eval=ATB, num_answers=len(ALBEF_ANSWERS),
                                       vocab_size=30522, question_len=LQ, answer_len=LA,
                                       max_answers_per_q=ANS_PER_Q, image_size=(ARES, ARES),
                                       batch_size=ATB, val_batch_size=ATB, seed=seed + 1 + i)
               for i, k in enumerate(TRAIN_CLIENTS)}
    hooks = resolve_trainer("albef_no_distill", "vqa", rank_k=ALBEF_K, answer_banks={
        k: (c.answer_ids, c.answer_mask) for k, c in clients.items()})
    tcfg = TrainConfig(encoder_name="albef_no_distill", peft_mode=PEFTMode.DAT,
                       optimizer=OptimizerConfig(),
                       federated=FederatedConfig(comm_rounds=2, local_epochs=1, eval_every=1),
                       num_epochs=1, seed=seed)
    federated_rounds(torch, "2 ALBEF clients x 1 fused step (tuned)", lambda: FederatedTrainer(
        model, params, clients, tcfg, make_forward=hooks.make_forward, make_eval=hooks.make_eval,
        use_fused_dat=True), captures=1 + 3, programs=2)


def block_route_path(torch, seed):
    """(f) the second path: the ViT on "block" with block_save_nox remat at
    B=16.  The region keeps #1's outputs (attn_ctx, attn_lse, attn_out), so
    #1 runs once per layer per pass; "full" runs it again in the backward.
    -> #3's launches per replayed step, measured from the device."""
    small = albef_train_batch(torch, SECOND_B, seed)
    blk = albef_train_model(torch, seed, "block", **TUNED_FLAGS)
    tuned_flags_check(blk, "block")
    bsd = blk.state_dict()
    bparams = {n: t.detach() for n, t in bsd.items()}
    vit = blk.cfg.vision_layers
    want_blk = {**NO_LAUNCHES, "attn_block": 2 * vit, "attn_block_bwd": 2 * (vit - 1)}
    step, state0 = albef_fused_step(torch, blk, bparams, seed)
    label = f"ALBEF fused DAT step (block, block_save_nox, dropout live, B={SECOND_B}x{ANS_PER_Q})"
    graph_path(torch, label, lambda: step(state0, small),
               lambda prev: step(prev[0] if prev else state0, small), want_blk)
    replay = graph_vs_eager(torch, label, lambda: step(state0, small), want_blk)
    del step
    runs = {}
    with graph_mode(False):
        for name, policy in (("block_save_nox", "block_save_nox"), ("no remat", None), ("full", "full")):
            flags = {**TUNED_FLAGS, "remat": policy is not None, "remat_policy": policy or "full"}
            m_ = blk if name == "block_save_nox" else albef_train_model(torch, seed, "block", state=bsd,
                                                                        **flags)
            step_, st0 = albef_fused_step(torch, m_, bparams, seed)
            torch.cuda.synchronize()
            reset_counts()
            runs[name] = step_tensors(torch, step_(st0, small), 0)
            torch.cuda.synchronize()
            counts = read_counts()
            print(f"albef_tuned: block route, {name}: launches per eager step {counts_text(counts)}")
            if name == "full":  # #1 runs again in the backward, #3 as often
                check(counts["attn_block"] > 2 * vit and counts["attn_block_bwd"] == 2 * (vit - 1),
                      f"'full' remat: launches {counts}")
            else:
                check(counts == want_blk, f"block route {name}: launches {counts}, expected {want_blk}")
            del step_, m_
    for name in ("no remat", "full"):
        bad = same_tensors(torch, f"block route, block_save_nox against {name}", runs["block_save_nox"],
                           runs[name])
        check(not bad, f"albef_tuned: block route, remat changes the step against {name}: {bad[:3]}")
    del blk, runs
    torch.cuda.empty_cache()
    return replay["attn_block_bwd"]


def long_kernel_times(torch, seed):
    """#1 and #3 (LN1 outside, as the model runs them past 448) and #4 at
    B=16, S=769 (the long-canvas path of gate_checks) and S=1024, with a
    padding bias: kernel, plain version, library chain and bound."""
    for s_long in (769, 1024):
        time_attn_block(torch, SECOND_B, s_long, seed, fuse_ln=False)
        attn_bwd_row(torch, SECOND_B, s_long, False, seed)
        layer_bwd_row(torch, SECOND_B, s_long, True, seed)


def vit_kernel_times(torch, seed):
    """(g) #1, #3 and #4 at S=577 without a padding bias: #1 and #4 at the
    tuned step's B=48, #3 at the second path's B=16."""
    time_attn_block(torch, ATB, VIT_S, seed, fuse_ln=False, masked=False)
    attn_bwd_row(torch, SECOND_B, VIT_S, False, seed, masked=False)
    layer_bwd_row(torch, ATB, VIT_S, True, seed, masked=False)


def profile_device(torch, fn, label, groups):
    """Device time of one call of ``fn`` by kernel, from torch.profiler, with
    the idle share of its wall time; ``groups`` sums kernels by name pieces."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        end.synchronize()
    wall_us = 1e3 * start.elapsed_time(end)
    by_name = {}
    n_device = n_launch = 0
    launch_us = 0.0
    for e in profile_events(torch, prof):
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            n_device += 1
        elif e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx"):
            n_launch += 1
            launch_us += e.self_cpu_time_total
    busy = sum(by_name.values())
    if busy == 0:
        print(f"profile {label}: torch.profiler recorded no device time")
        return
    shares = {g: sum(t for n, t in by_name.items() if any(k in n for k in keys))
              for g, keys in groups.items()}
    print(f"profile {label}: wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
          f"(idle {100 * (1 - busy / wall_us):.1f}%), "
          + ", ".join(f"{g} {t / 1e3:.3f} ms ({100 * t / busy:.1f}%)" for g, t in shares.items())
          + f", other {(busy - sum(shares.values())) / 1e3:.3f} ms; host: {n_device} device "
          f"operations, {n_launch} kernel launch calls taking {launch_us / 1e3:.3f} ms of CPU")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {t / 1e3:8.3f} ms {100 * t / busy:5.1f}%  {name[:110]}")


# ------------------------------------------------------------------ from_disk
# The path from files on disk to answers (phase 12): two registered tasks
# whose image backends differ, each a client with 128 train and 64 eval
# questions of 10 crowd answers, on JPEGs of mixed size and aspect (every
# canvas but one padded), loaded by the port's own loaders into the tuned
# ViLT script's pipeline (scripts/train_vilt_tpu_tuned.sh: --batch_size 64
# --val_batch_size 64 --cache_images --device_normalize, canvas 384x640).
DISK_TASKS = ("vizwiz", "gqa")
DISK_TRAIN, DISK_EVAL, DISK_CROWD, DISK_PER_IMAGE = 128, 64, 10, 3
DISK_SIZES = ((640, 480), (480, 640), (500, 500), (800, 600), (375, 500), (612, 612),
              (1024, 683), (427, 640), (300, 300), (640, 360), (333, 500), (1280, 768))
DISK_ROUNDS = 3
DISK_AB = ATB  # the ALBEF part's batch: the ALBEF phases' 48 questions x 4 answers
DISK_WORDS = ("what", "color", "is", "the", "cat", "on", "left", "how", "many", "people", "are",
              "there", "in", "picture", "does", "this", "man", "have", "a", "hat", "where",
              "which", "sign", "say", "kind", "of", "food", "room", "weather", "like")


def write_disk_dataset(root, seed):
    """Write :data:`DISK_TASKS` under ``root`` in the reference's on-disk
    layout: each task's images where its backend looks for them, its
    questions-and-annotations JSON per split (``datasets.raw_json_paths``),
    VQAv2-style annotation files and the ``ans2label`` that the port's
    ``make_labels`` builds from them (``datasets.ans2label_path``)."""
    import json
    import os

    import numpy as np
    from PIL import Image

    from feddat_tpu_torch.configs.tasks import TASK_CONFIGS
    from feddat_tpu_torch.data.datasets import ans2label_path, raw_json_paths
    from feddat_tpu_torch.data.images import make_backend
    from feddat_tpu_torch.data.make_labels import write_vqa_labels

    rng = np.random.RandomState(seed)
    t0 = time.perf_counter()
    n_bytes = 0
    for t, task in enumerate(DISK_TASKS):
        spec = TASK_CONFIGS[task]
        data_dir = os.path.join(root, spec.data_dir)
        backend = make_backend(spec.images_source, task, root)
        n_images = (DISK_TRAIN + DISK_EVAL) // DISK_PER_IMAGE
        files = []
        for i in range(n_images):
            # vizwiz keys images by file name, VG by the numeric stem
            fname = f"VizWiz_train_{i:08d}.jpg" if task == "vizwiz" else f"{(t + 1) * 100000 + i}.jpg"
            image_id = fname if task == "vizwiz" else fname.split(".")[0]
            w, h = DISK_SIZES[(i + t) % len(DISK_SIZES)]
            coarse = rng.randint(0, 256, (h // 16 + 1, w // 16 + 1, 3), dtype=np.uint8)
            noise = rng.randint(-12, 13, (h, w, 3))
            img = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BILINEAR), np.int32)
            path = backend.path_for(image_id)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            Image.fromarray(np.clip(img + noise, 0, 255).astype(np.uint8)).save(path, quality=90)
            n_bytes += os.path.getsize(path)
            files.append(f"images/{fname}")
        # each question's answers: its main answer (every answer of the pool
        # is some question's) and crowd noise, 10 in all
        qid = (t + 1) * 1_000_000
        for split, n in zip(spec.splits, (DISK_TRAIN, DISK_EVAL)):
            rows, annos = [], []
            for j in range(n):
                main = ALBEF_ANSWERS[(j * 7 + t) % len(ALBEF_ANSWERS)]
                k = rng.randint(5, DISK_CROWD + 1)
                crowd = [main] * k + [ALBEF_ANSWERS[a] for a in
                                      rng.randint(0, len(ALBEF_ANSWERS), DISK_CROWD - k)]
                words = rng.choice(DISK_WORDS, size=rng.randint(4, 14))
                rows.append({"question_id": qid, "question": " ".join(words) + "?",
                             "image": files[(j + (DISK_TRAIN if split != spec.splits[0] else 0))
                                            // DISK_PER_IMAGE],
                             "answer": crowd})
                annos.append({"question_id": qid, "multiple_choice_answer": main})
                qid += 1
            questions, _ = raw_json_paths(task, data_dir, split, root)
            os.makedirs(os.path.dirname(questions), exist_ok=True)
            with open(questions, "w") as f:
                json.dump(rows, f)
            with open(os.path.join(data_dir, f"annotations_{split}.json"), "w") as f:
                json.dump({"annotations": annos}, f)
        labels = ans2label_path(task, data_dir, root)
        os.makedirs(os.path.dirname(labels), exist_ok=True)
        write_vqa_labels([os.path.join(data_dir, f"annotations_{s}.json") for s in spec.splits],
                         labels, min_occurrences=1)
    print(f"from_disk: wrote {len(DISK_TASKS)} tasks x ({DISK_TRAIN} + {DISK_EVAL}) questions on "
          f"{len(DISK_TASKS) * ((DISK_TRAIN + DISK_EVAL) // DISK_PER_IMAGE)} JPEGs "
          f"({n_bytes / 2 ** 20:.1f} MiB) in {time.perf_counter() - t0:.2f} s")


def disk_tokenizer():
    from feddat_tpu_torch.data.tokenizer import WordPieceTokenizer

    return WordPieceTokenizer.from_vocab_file(str(REPO / "tests" / "fixtures" / "vocab30k.txt"))


def disk_split(root, task):
    """-> (train examples, eval examples, image backend, ans2label) of one
    task, by the port's loaders."""
    import os

    from feddat_tpu_torch.configs.tasks import TASK_CONFIGS
    from feddat_tpu_torch.data.datasets import load_ans2label, load_examples
    from feddat_tpu_torch.data.images import make_backend

    spec = TASK_CONFIGS[task]
    data_dir = os.path.join(root, spec.data_dir)
    train = load_examples(task, data_dir, spec.splits[0], data_root=root)
    evals = load_examples(task, data_dir, spec.splits[1], data_root=root)
    return (train, evals, make_backend(spec.images_source, task, root),
            load_ans2label(task, data_dir, root))


def disk_pipeline(root, task, seed, tok):
    from feddat_tpu_torch.configs.tasks import TASK_CONFIGS
    from feddat_tpu_torch.data.pipeline import ViltVQAPipeline

    train, evals, backend, _ = disk_split(root, task)
    check(len(train) == DISK_TRAIN and len(evals) == DISK_EVAL,
          f"{task}: loaded {len(train)} train and {len(evals)} eval examples")
    return ViltVQAPipeline(train, backend, tok, num_labels=TASK_CONFIGS[task].num_labels,
                           max_text_len=TEXT_LEN, canvas=CANVAS, batch_size=TB, val_batch_size=TB,
                           seed=seed, num_workers=8, eval_examples=evals, cache_images=True,
                           pixels_u8=True)


# The ViLT family's other tasks on disk, each in its reference layout under
# its TaskSpec.data_dir: NLVR2 (image pairs), SNLI-VE (Flickr30K ids), VCR
# (four choices, drawn images) and VQAv2 (COCO ids, the 5% low-shot client).
# The counts are what the CLI's low-shot draws keep at B=64: NLVR2 and SNLI-VE
# are under their per-class caps (all kept), VCR and VQAv2 keep 5%: 2 train
# steps and one eval batch per client (NLVR2 at 32 pairs, the halved batch).
CLS_TASKS = ("nlvr2", "snli-ve", "vcr")
CLS_COUNTS = {"nlvr2": (64, 32), "snli-ve": (128, 64), "vcr": (2560, 1280), "vqa": (2560, 1280)}


def write_classification_dataset(root, seed, counts=CLS_COUNTS, sizes=DISK_SIZES):
    """Write the tasks of ``counts`` (train, eval examples) under ``root`` as
    the port's loaders (``data/classification_datasets.py``,
    ``datasets.load_vqav2_examples``) read them: one image per size in
    ``sizes`` for each split, linked under every name an example needs."""
    import json
    import os
    import pickle

    import numpy as np
    from PIL import Image

    from feddat_tpu_torch.configs.tasks import TASK_CONFIGS
    from feddat_tpu_torch.data.classification_datasets import SNLI_VE_CATEGORIES

    rng = np.random.RandomState(seed)
    t0 = time.perf_counter()

    def pool(directory, ext):
        """One image per size, written once per split."""
        os.makedirs(directory, exist_ok=True)
        paths = []
        for i, (w, h) in enumerate(sizes):
            coarse = rng.randint(0, 256, (h // 16 + 1, w // 16 + 1, 3), dtype=np.uint8)
            path = os.path.join(directory, f"_pool_{i}.{ext}")
            Image.fromarray(coarse).resize((w, h), Image.BILINEAR).save(path, compress_level=1)
            paths.append(path)
        return paths

    def link(src, dst):
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        try:
            os.link(src, dst)
        except OSError:
            shutil.copyfile(src, dst)

    def sentence(lo=4, hi=14):
        return " ".join(rng.choice(DISK_WORDS, size=rng.randint(lo, hi)))

    def tagged(objects):
        """A VCR token list: words, some replaced by an object tag [index]."""
        return [[int(rng.randint(len(objects)))] if rng.rand() < 0.3 else str(w)
                for w in sentence(3, 10).split()]

    def jsonl(path, rows):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write("\n".join(json.dumps(r) for r in rows) + "\n")

    for task, (n_train, n_eval) in counts.items():
        data_dir = os.path.join(root, TASK_CONFIGS[task].data_dir)
        if task == "nlvr2":  # data/{train,dev}.json; images/<split>/<base>-img{0,1}.png
            for split, n in (("train", n_train), ("dev", n_eval)):
                images = pool(os.path.join(data_dir, "_pool", split), "png")
                rows = []
                for i in range(n):
                    base = f"{split}-{i}-{i % 7}"
                    for k in (0, 1):
                        link(images[(2 * i + k) % len(images)],
                             os.path.join(data_dir, "images", split, f"{base}-img{k}.png"))
                    rows.append({"identifier": f"{base}-0", "sentence": sentence(),
                                 "label": "True" if i % 2 else "False"})
                jsonl(os.path.join(data_dir, "data", f"{split}.json"), rows)
        elif task == "snli-ve":  # snli_ve_{split}.jsonl over flickr30k/images/<id>.jpg
            flickr = os.path.join(root, "flickr30k", "images")
            for s, (split, n) in enumerate((("train", n_train), ("dev", n_eval))):
                images = pool(os.path.join(root, "flickr30k", "_pool", split), "jpg")
                rows = []
                for i in range(n):
                    image_id = (s + 1) * 100000 + i // 3
                    if i % 3 == 0:
                        link(images[(i // 3) % len(images)], os.path.join(flickr, f"{image_id}.jpg"))
                    rows.append({"Flickr30K_ID": str(image_id), "sentence2": sentence(),
                                 "gold_label": SNLI_VE_CATEGORIES[(i + s) % 3]})
                jsonl(os.path.join(data_dir, f"snli_ve_{split}.jsonl"), rows)
        elif task == "vcr":  # annotation/{split}.jsonl; drawn_images/<split>/qa/<annot_id>.jpg
            objects = ["person", "dog", "person", "car", "cup", "person"]
            for split, n in (("train", n_train), ("val", n_eval)):
                images = pool(os.path.join(data_dir, "_pool", split), "jpg")
                # the texts come from a pool: most rows only feed the 5% draw
                texts = [tagged(objects) for _ in range(64)]
                rows = []
                for i in range(n):
                    annot_id = f"{split}-{i}"
                    link(images[i % len(images)],
                         os.path.join(data_dir, "drawn_images", split, "qa", f"{annot_id}.jpg"))
                    q, *choices = [texts[j] for j in rng.randint(len(texts), size=9)]
                    rows.append({"annot_id": annot_id, "objects": objects, "question": q,
                                 "answer_choices": choices[:4],
                                 "answer_label": int(rng.randint(4)),
                                 "rationale_choices": choices[4:],
                                 "rationale_label": int(rng.randint(4))})
                jsonl(os.path.join(data_dir, "annotation", f"{split}.jsonl"), rows)
        else:  # VQAv2: questions, annotations and ans2label.pkl; mscoco/<split>2014 by id
            os.makedirs(data_dir, exist_ok=True)
            with open(os.path.join(data_dir, "ans2label.pkl"), "wb") as f:
                pickle.dump({a: j for j, a in enumerate(ALBEF_ANSWERS)}, f)
            for s, (split, n) in enumerate((("train", n_train), ("val", n_eval))):
                images = pool(os.path.join(root, "mscoco", "_pool", split), "jpg")
                questions, annotations = [], []
                texts = [sentence() for _ in range(64)]
                for i in range(n):
                    image_id = (s + 1) * 100000 + i % len(images)
                    if i < len(images):
                        link(images[i], os.path.join(root, "mscoco", f"{split}2014",
                                                     f"COCO_{split}2014_{image_id:012d}.jpg"))
                    qid = image_id * 1000 + i
                    main = ALBEF_ANSWERS[(i * 7 + s) % len(ALBEF_ANSWERS)]
                    k = rng.randint(5, DISK_CROWD + 1)
                    crowd = [main] * k + [ALBEF_ANSWERS[a] for a in
                                          rng.randint(0, len(ALBEF_ANSWERS), DISK_CROWD - k)]
                    questions.append({"question_id": qid, "image_id": image_id,
                                      "question": texts[rng.randint(len(texts))] + "?"})
                    annotations.append({"question_id": qid, "image_id": image_id,
                                        "answers": [{"answer": a} for a in crowd]})
                with open(os.path.join(data_dir, f"v2_OpenEnded_mscoco_{split}2014_questions.json"),
                          "w") as f:
                    json.dump({"questions": questions}, f)
                with open(os.path.join(data_dir, f"v2_mscoco_{split}2014_annotations.json"), "w") as f:
                    json.dump({"annotations": annotations}, f)
    print(f"classify: wrote {dict(counts)} (train, eval) examples on {len(sizes)} images per split "
          f"and task in {time.perf_counter() - t0:.2f} s")


def disk_key_bias(torch, root, seed):
    """The key bias the ViLT model builds for the first train batch of the
    fixture's first client ([TB, 1, 1, S], -10000 at padded text and image
    keys), as models/vilt.py builds it from the compact pixel mask."""
    from feddat_tpu_torch.ops.attention import mask_to_bias

    batch = next(disk_pipeline(root, DISK_TASKS[0], seed, disk_tokenizer()).train_batches(0))
    dims = torch.from_numpy(batch["pixel_mask"])
    H, W = CANVAS
    pm = ((torch.arange(H)[None, :, None] < dims[:, 0, None, None])
          & (torch.arange(W)[None, None, :] < dims[:, 1, None, None])).to(torch.int32)
    pm = pm.reshape(TB, H // 32, 32, W // 32, 32).amax(dim=(2, 4)).reshape(TB, -1)
    text = torch.from_numpy(batch["attention_mask"])
    mask = torch.cat([text, torch.ones(TB, 1, dtype=text.dtype), pm.to(text.dtype)], dim=1)
    check(mask.shape == (TB, S), f"fixture mask shape {tuple(mask.shape)}")
    padded = int((pm.sum(-1) < pm.shape[1]).sum())
    print(f"from_disk: the fixture's first train batch masks {int((mask == 0).sum())} of {mask.numel()} "
          f"keys; {padded} of {TB} canvases padded, text keys masked {int((text == 0).sum())}")
    check(padded > 0, "no padded canvas in the fixture's first batch")
    return mask_to_bias(mask).cuda()


def disk_parity(torch, root, seed):
    """#1 at the from-disk training shape (B=64, S=281, LN1 fused) and #4 in
    both adapter modes, on the key mask of the fixture's canvases, under the
    limits of the other cases."""
    bias = disk_key_bias(torch, root, seed)
    attn_parity(torch, TB, S, True, seed + 7, bias=bias)
    for use_b in (True, False):
        layer_bwd_parity(torch, TB, S, use_b, seed + 7, bias=bias)


class RoundClock:
    """The engine's metrics hook (``metrics_logger``), called after each
    round's evaluation: ``walls`` holds each round's ``run_round`` time as
    the engine measures it (the host's: the last steps may still run on the
    card), ``periods`` the time from the previous evaluation (or from
    ``start()``) to this one: the round, its checkpoint and its evaluation,
    which reads its scores back from the card."""

    def __init__(self):
        self.walls, self.periods = {}, {}
        self.t = time.perf_counter()

    def start(self):
        self.t = time.perf_counter()

    def step(self, scalars, batch_size, task_key):
        pass

    def round(self, round_idx, scores, wall_s):
        now = time.perf_counter()
        self.walls[round_idx], self.periods[round_idx] = wall_s, now - self.t
        self.t = now

    def text(self):
        return ", ".join(f"round {r}: {self.periods[r]:.3f} s (run_round {self.walls[r]:.3f} s)"
                         for r in sorted(self.walls))


def disk_model(seed):
    """Full-width ViLT-B/32 DAT at reduction 16, bf16, on "layer" (#1/#4),
    a 100-label head per task (TASK_CONFIGS), the fixture's canvas."""
    from feddat_tpu_torch.configs.core import PEFTMode
    from feddat_tpu_torch.configs.tasks import TASK_CONFIGS
    from feddat_tpu_torch.models import create_model
    from feddat_tpu_torch.models.vilt import TaskHeadSpec

    model, cfg = create_model(
        "vilt", {t: TaskHeadSpec(num_labels=TASK_CONFIGS[t].num_labels) for t in DISK_TASKS},
        PEFTMode.DAT, 16, "bfloat16", image_size=CANVAS, attn_impl="layer", seed=seed)
    check(cfg.fuse_ln and cfg.hidden_dropout == 0.0 and cfg.image_size == CANVAS,
          f"unexpected model config {cfg}")
    return model


def disk_trainer(model, params, root, seed, directory, transform=None, clock=None):
    from feddat_tpu_torch.configs.core import FederatedConfig, OptimizerConfig, PEFTMode, TrainConfig
    from feddat_tpu_torch.federated.engine import FederatedTrainer

    tok = disk_tokenizer()
    clients = {task: disk_pipeline(root, task, seed + i, tok) for i, task in enumerate(DISK_TASKS)}
    cfg = TrainConfig(peft_mode=PEFTMode.DAT, optimizer=OptimizerConfig(),
                      federated=FederatedConfig(comm_rounds=DISK_ROUNDS, local_epochs=1, eval_every=1),
                      num_epochs=DISK_ROUNDS, seed=seed)
    return FederatedTrainer(model, params, clients, cfg, use_fused_dat=True, checkpoint_dir=directory,
                            batch_transform=transform, metrics_logger=clock)


def sigterm_at(first_step):
    """A batch_transform that raises SIGTERM at the engine's ``first_step``-th
    step, after checking that the engine's latch holds SIGTERM."""
    import itertools
    import signal

    from feddat_tpu_torch.utils.preemption import GracefulPreemption

    calls = itertools.count()

    def transform(batch, epoch, step, steps_per_epoch):
        if next(calls) == first_step:
            handler = signal.getsignal(signal.SIGTERM)
            check(isinstance(getattr(handler, "__self__", None), GracefulPreemption),
                  f"SIGTERM is not latched by the engine: {handler}")
            print("from_disk: run B: SIGTERM raised at the first step of round 1", flush=True)
            signal.raise_signal(signal.SIGTERM)
        return batch

    return transform


def same_state(torch, label, want, trainer):
    """``want`` = (server parameters, personal stores, history) against the
    trainer's: every tensor and the last evaluation, bitwise."""
    server, personal, history = want
    bad = [k for k in server if not torch.equal(server[k], trainer.server_params[k])]
    bad += [f"{c}/{k}" for c in personal for k in personal[c]
            if not torch.equal(personal[c][k], trainer.personal[c][k])]
    n = len(server) + sum(len(v) for v in personal.values())
    print(f"from_disk: {label}: {len(bad)} of {n} tensors differ (bitwise rule); last evaluation "
          f"{history[-1]} vs {trainer.history[-1]}")
    check(not bad, f"{label}: tensors differ: {bad[:4]}")
    check(history[-1] == trainer.history[-1], f"{label}: the last evaluations differ")


def round_profile(torch, fn, lead=2):
    """One replayed call of ``fn`` (a round) after ``lead`` uncounted ones
    (:func:`profile_calls`) -> (device busy ms, wall ms by the host clock
    around the call and a synchronize, idle share, ms and count of the
    host-to-device copies among the device events: the prefetched batches
    and the eval batches)."""
    walls = []

    def timed():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    per_call, _ = profile_calls(torch, timed, 1, lead)
    check(per_call is not None, "the round's profile lost its calls")
    busy = sum(us for _, us, _ in per_call[0]) / 1e3
    h2d = {"pinned": [], "pageable": []}
    for _, us, name in per_call[0]:
        name = name.lower()
        if "htod" in name.replace(" ", ""):
            h2d["pinned" if "pinned" in name else "pageable"].append(us)
    wall = walls[-1] * 1e3
    return busy, wall, 1.0 - busy / wall, {k: (len(v), sum(v) / 1e3) for k, v in h2d.items()}


def disk_serving(torch, root, seed, directory, trainer):
    """``ViltVqaPredictor.from_checkpoint`` for each client on the "block"
    route with fused LN and the fused ensemble adapter (#1, #2): its
    answers to the client's eval questions bitwise those of a predictor
    built from the trainer's client parameters, and within 5% of the largest
    probability of the plain route's."""
    import dataclasses

    from feddat_tpu_torch.configs.core import PEFTMode
    from feddat_tpu_torch.configs.tasks import TASK_CONFIGS
    from feddat_tpu_torch.models import create_model
    from feddat_tpu_torch.models.vilt import TaskHeadSpec
    from feddat_tpu_torch.ops import adapter_fused as af
    from feddat_tpu_torch.ops import attn_block as ab
    from feddat_tpu_torch.serving import ViltVqaPredictor
    from feddat_tpu_torch.utils.checkpointing import write_meta

    heads = {t: TaskHeadSpec(num_labels=TASK_CONFIGS[t].num_labels) for t in DISK_TASKS}
    write_meta(directory, {
        "encoder_name": "vilt", "optimizer_mode": "dat", "adapter_reduction_factor": 16,
        "dtype": "bfloat16", "engine": "sequential", "tasks": list(DISK_TASKS), "smoke": False,
        "image_size": list(CANVAS), "attention_logits_dtype": "float32",
        "heads": {t: dataclasses.asdict(h) for t, h in heads.items()}})

    def model(attn_impl, fused):
        return create_model("vilt", heads, PEFTMode.DAT, 16, "bfloat16", image_size=CANVAS,
                            attn_impl=attn_impl, adapter_fused=fused, seed=seed + 99)[0]

    tok = disk_tokenizer()
    common = dict(batch_size=B, canvas=CANVAS, max_text_len=TEXT_LEN)
    served, direct, plain = model("block", True), model("block", True), model("auto", False)
    for i, task in enumerate(DISK_TASKS):
        _, evals, backend, a2l = disk_split(root, task)
        label2ans = [None] * TASK_CONFIGS[task].num_labels
        for answer, j in a2l.items():
            label2ans[j] = answer
        imgs = [backend.load(e.image_id) for e in evals]
        qs = [e.question for e in evals]
        t0 = time.perf_counter()
        pred = ViltVqaPredictor.from_checkpoint(directory, tok, label2ans, task_key=task,
                                                model=served, **common)
        load_s = time.perf_counter() - t0
        check(pred.adapter_mode == "ensemble", f"adapter mode {pred.adapter_mode}")
        reset_counts()
        got = pred.predict(imgs, qs, top_k=5)
        torch.cuda.synchronize()
        launches = read_counts()
        want_launches = {**NO_LAUNCHES, "attn_block": 12 * len(imgs) // B,
                         "adapter_fused": 12 * len(imgs) // B}
        check(launches == want_launches,
              f"from_checkpoint predict launches {launches}, expected {want_launches}")
        params = trainer._client_params(trainer.clients[i], refresh=False)
        ref = ViltVqaPredictor(direct, params, task, tok, label2ans, **common)
        want = ref.predict(imgs, qs, top_k=5)
        batch = pred._preprocess(imgs[:B], qs[:B])
        probs, probs_ref = pred.forward(batch), ref.forward(batch)
        probs_plain = ViltVqaPredictor(plain, params, task, tok, label2ans, **common).forward(batch)
        diff, top = float(abs(probs - probs_plain).max()), float(probs_plain.max())
        print(f"from_disk: serving {task}: from_checkpoint in {load_s:.2f} s; {len(got)} answers; "
              f"launches {counts_text(launches)}; bitwise equal to the trainer's params' "
              f"predictor: answers {got == want}, probabilities {bool((probs == probs_ref).all())}; "
              f"plain route max_abs_diff {diff:.3e} (tol {0.05 * top:.3e}, 5% of max prob {top:.3e}); "
              f"first answer {got[0][:2]}")
        check(got == want and bool((probs == probs_ref).all()),
              f"{task}: the served predictor differs from the trainer's params' predictor")
        check(diff <= 0.05 * top, f"{task}: the kernel route disagrees with the plain route")


def disk_albef(torch, root, seed, directory):
    """``AlbefVQAPipeline`` feeds one ALBEF client ("flash", dropout 0.1 live,
    the fused DAT step) for one round with a checkpoint, and
    ``AlbefVqaPredictor.from_checkpoint`` ranks its eval questions with the
    recipe's answer list (#7), bitwise a predictor built from the trainer's
    client parameters."""
    from feddat_tpu_torch.configs.core import FederatedConfig, OptimizerConfig, PEFTMode, TrainConfig
    from feddat_tpu_torch.data.albef_pipeline import AlbefVQAPipeline
    from feddat_tpu_torch.federated.engine import FederatedTrainer
    from feddat_tpu_torch.serving import AlbefVqaPredictor
    from feddat_tpu_torch.train.trainers import resolve_trainer
    from feddat_tpu_torch.utils.checkpointing import latest_round, write_meta

    task = DISK_TASKS[0]
    train, evals, backend, a2l = disk_split(root, task)
    answers = sorted(a2l, key=a2l.get)
    tok = disk_tokenizer()
    pipe = AlbefVQAPipeline(train, backend, tok, answers, image_size=ARES, max_question_len=LQ,
                            max_answer_len=LA, max_answers_per_q=ANS_PER_Q, batch_size=DISK_AB,
                            val_batch_size=DISK_AB, seed=seed, num_workers=8, eval_examples=evals,
                            cache_images=True, pixels_u8=True)
    model = albef_train_model(torch, seed, "flash")
    params = {k: v.detach() for k, v in model.state_dict().items()}
    hooks = resolve_trainer("albef_no_distill", "vqa", rank_k=ALBEF_K,
                            answer_banks={task: (pipe.answer_ids, pipe.answer_mask)})
    cfg = TrainConfig(encoder_name="albef_no_distill", peft_mode=PEFTMode.DAT,
                      optimizer=OptimizerConfig(),
                      federated=FederatedConfig(comm_rounds=1, local_epochs=1, eval_every=1),
                      num_epochs=1, seed=seed)
    trainer = FederatedTrainer(model, params, {task: pipe}, cfg, make_forward=hooks.make_forward,
                               make_eval=hooks.make_eval, use_fused_dat=True, checkpoint_dir=directory)
    reset_counts()
    t0 = time.perf_counter()
    history = trainer.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = read_counts()
    print(f"from_disk: ALBEF {task}: 1 round of {pipe.steps_per_epoch} fused steps (B={DISK_AB} x "
          f"{ANS_PER_Q} answers, dropout 0.1) and rank-answer eval over a {len(answers)}-answer bank "
          f"in {run_s:.2f} s, captures included; launches {counts_text(counts)}; eval {history[-1]}")
    check(latest_round(directory) == 0 and len(history) == 1, "the ALBEF round was not checkpointed")
    check(min(counts[k] for k in FLASH_KEYS) > 0, f"the ALBEF round missed a flash kernel: {counts}")
    write_meta(directory, {
        "encoder_name": "albef_no_distill", "optimizer_mode": "dat", "adapter_reduction_factor": 16,
        "dtype": "bfloat16", "engine": "sequential", "tasks": [task], "smoke": False,
        "image_size": None, "attention_logits_dtype": "float32",
        "heads": {task: {"num_labels": len(answers)}}, "answer_lists": {task: answers}})
    common = dict(batch_size=AB, k=ALBEF_K, max_question_len=LQ, max_answer_len=LA)
    served = AlbefVqaPredictor.from_checkpoint(directory, tok, model=albef_train_model(torch, seed + 1,
                                                                                       "flash"),
                                               **common)
    check(served.answer_list == answers and served.adapter_mode == "ensemble",
          "the ALBEF recipe's answer list or adapter mode was not taken")
    imgs, qs = [backend.load(e.image_id) for e in evals[:2 * AB]], [e.question for e in evals[:2 * AB]]
    reset_counts()
    got = served.predict(imgs, qs, top_k=5)
    torch.cuda.synchronize()
    served_counts = read_counts()
    ref = AlbefVqaPredictor(albef_train_model(torch, seed + 2, "flash"),
                            trainer._client_params(trainer.clients[0], refresh=False), tok, answers,
                            **common)
    want = ref.predict(imgs, qs, top_k=5)
    batch = served._preprocess(imgs[:AB], qs[:AB])
    ids, probs = served.rank(batch)
    ids_ref, probs_ref = ref.rank(batch)
    same = got == want and (ids == ids_ref).all() and (probs == probs_ref).all()
    print(f"from_disk: ALBEF from_checkpoint predict over {len(imgs)} questions: launches "
          f"{counts_text(served_counts)}; bitwise equal to the trainer's params' predictor: {bool(same)}; "
          f"first answer {got[0][:2]}")
    check(served_counts == {**NO_LAUNCHES, "flash_attention": 54 * len(imgs) // AB},
          f"ALBEF predict launches {served_counts}")
    check(bool(same), "the served ALBEF predictor differs from the trainer's params' predictor")


def phase_from_disk(torch, seed, root):
    """Phase 12 (see the module docstring): dataset on disk -> pipeline ->
    prefetch -> fused DAT rounds with a checkpoint per round -> SIGTERM ->
    relaunch and resume -> from_checkpoint -> answers."""
    import os

    from feddat_tpu_torch.train import compiled, dat
    from feddat_tpu_torch.train.forwards import to_device
    from feddat_tpu_torch.utils.checkpointing import (
        latest_round,
        restore_federated_state,
        save_federated_state,
    )

    t_phase = time.perf_counter()
    work = os.path.join(root, "checkpoints")
    dir_a, dir_b, dir_c = (os.path.join(work, n) for n in ("a", "b", "albef"))

    # host ms per batch, the u8 cache cold and warm
    tok = disk_tokenizer()
    pipe = disk_pipeline(root, DISK_TASKS[0], seed, tok)
    chunk = pipe.examples[:TB]
    host = []
    for _ in range(2):
        t0 = time.perf_counter()
        batch = pipe._make_batch(chunk)
        host.append(1e3 * (time.perf_counter() - t0))
    dims = batch["pixel_mask"]
    padded = int(((dims[:, 0] < CANVAS[0]) | (dims[:, 1] < CANVAS[1])).sum())
    print(f"from_disk: host ms per batch of {TB} (decode, resize, pack, tokenize): cache cold "
          f"{host[0]:.1f}, warm {host[1]:.1f}; pixels {batch['pixel_values'].dtype} "
          f"{batch['pixel_values'].shape}; canvases padded {padded} of {TB}")
    del pipe

    model = disk_model(seed)
    params = {k: v.detach() for k, v in model.state_dict().items()}
    layers = model.config.num_layers
    steps_per_round = len(DISK_TASKS) * (DISK_TRAIN // TB)

    # run A: three rounds, never interrupted
    clock = RoundClock()
    run_a = disk_trainer(model, params, root, seed, dir_a, clock=clock)
    cap0 = compiled.STATS["captures"]
    reset_counts()
    t0 = time.perf_counter()
    clock.start()
    run_a.run()
    torch.cuda.synchronize()
    run_a_s = time.perf_counter() - t0
    counts = read_counts()
    print(f"from_disk: run A: {DISK_ROUNDS} rounds of {len(DISK_TASKS)} clients x {DISK_TRAIN // TB} "
          f"fused steps (B={TB}, S={S}) in {run_a_s:.2f} s; from disk, each round with its "
          f"checkpoint and evaluation: {clock.text()} (round 0 captures and fills the u8 cache); "
          f"{compiled.STATS['captures'] - cap0} captures; launches {counts_text(counts)}; evals "
          f"{[e['scores'] for e in run_a.history]}")
    want = {**NO_LAUNCHES, "attn_block": DISK_ROUNDS * steps_per_round * 2 * layers
            + DISK_ROUNDS * len(DISK_TASKS) * 3 * layers * (DISK_EVAL // TB),
            "layer_block_bwd": DISK_ROUNDS * steps_per_round * 2 * layers}
    check(counts == want, f"run A launches {counts}, expected {want}")
    check(latest_round(dir_a) == DISK_ROUNDS - 1, "run A did not checkpoint its last round")

    # one checkpoint's save and restore, timed
    t0 = time.perf_counter()
    path = save_federated_state(work, 99, run_a.server_params, run_a.personal, run_a.rng)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored = restore_federated_state(work, 99)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    print(f"from_disk: save_federated_state {save_s:.3f} s, {size} bytes ({size / 2 ** 20:.1f} MiB, "
          f"{len(run_a.server_params)} server tensors + {len(DISK_TASKS)} personal stores); restore "
          f"{restore_s:.3f} s onto the card")
    check(all(torch.equal(restored[1][k], v) for k, v in run_a.server_params.items()),
          "the restored server parameters differ")
    del restored
    os.remove(path)

    done_a = (run_a.server_params, {c: dict(v) for c, v in run_a.personal.items()},
              list(run_a.history))

    # the launches per step of #1 and #4 from the device, and the device's
    # idle share over one replayed round (a fourth round: run A is done)
    client = run_a.clients[0]
    state0 = dat.init_train_state(run_a._client_params(client), client.partitioner, client.opt_cfg,
                                  torch.Generator().manual_seed(seed))
    batch = to_device(next(client.data.train_batches(0)), torch.device("cuda"))
    row = call_profile(torch, "from-disk fused DAT step", [True],
                       lambda g: client.train_step(state0, batch))[0]
    dev = device_launches(row["port"])
    print(f"from_disk: one replayed fused step (B={TB}, S={S}), from the device's kernel names: "
          f"#1 {dev['attn_block']}, #4 {dev['layer_block_bwd']} launches; busy {row['busy']:.3f} ms of "
          f"{row['ms']:.3f} ms")
    check(dev["attn_block"] == 2 * layers and dev["layer_block_bwd"] == 2 * layers,
          f"device launches per step {dev}")
    del state0, batch
    busy, wall, idle, h2d = round_profile(torch, lambda: run_a.run_round(DISK_ROUNDS))
    print(f"from_disk: one replayed round ({steps_per_round} steps, host batches from the warm cache "
          f"through the prefetch): wall {wall:.3f} ms, device busy {busy:.3f} ms, idle share "
          f"{100 * idle:.1f}%; host-to-device copies from pinned memory {h2d['pinned'][0]} in "
          f"{h2d['pinned'][1]:.3f} ms of device time ({steps_per_round} batches, each "
          f"{TB * CANVAS[0] * CANVAS[1] * 3 / 2 ** 20:.1f} MiB of u8 pixels), from pageable "
          f"memory {h2d['pageable'][0]} in {h2d['pageable'][1]:.3f} ms")
    del run_a, client
    torch.cuda.empty_cache()

    # run B: SIGTERM inside round 1, then a fresh trainer resumes
    cut = disk_trainer(model, params, root, seed, dir_b,
                       transform=sigterm_at(steps_per_round))
    history = cut.run()
    print(f"from_disk: run B: returned after rounds {[e['round'] for e in history]}; latest "
          f"checkpoint round {latest_round(dir_b)}")
    check([e["round"] for e in history] == [0, 1] and latest_round(dir_b) == 1,
          "the SIGTERM run did not stop after checkpointing round 1")
    check(history == done_a[2][:2], "run B's first two evaluations differ from run A's")
    del cut
    torch.cuda.empty_cache()
    clock_b = RoundClock()
    relaunch = disk_trainer(model, params, root, seed, dir_b, clock=clock_b)
    t0 = time.perf_counter()
    clock_b.start()
    history = relaunch.run()
    torch.cuda.synchronize()
    print(f"from_disk: run B relaunched: resumed and ran rounds {[e['round'] for e in history]} in "
          f"{time.perf_counter() - t0:.2f} s: {clock_b.text()} (the restore, the captures and a cold "
          f"u8 cache included)")
    check([e["round"] for e in history] == [DISK_ROUNDS - 1], "the relaunch did not resume at round 2")
    same_state(torch, "run A against run B (SIGTERM in round 1, resumed)", done_a, relaunch)
    disk_serving(torch, root, seed, dir_b, relaunch)
    del relaunch, model, params, done_a
    torch.cuda.empty_cache()

    disk_albef(torch, root, seed, dir_c)
    torch.cuda.empty_cache()
    print(f"from_disk: phase took {time.perf_counter() - t_phase:.1f} s")


CLI_TASKS = ",".join(DISK_TASKS)
CLI_SPLITS = ("train", "val_small")  # both disk tasks' TaskSpec.splits
CLI_ROUNDS = 2


def script_flags(name, engine=False):
    """The flags ``scripts/<name>`` passes to ``python -m feddat_tpu.cli``,
    each ``${VAR:-default}`` at its default, ``"$@"`` left out, and
    ``--engine spmd`` kept with ``engine`` (else the sequential engine runs:
    the SPMD engine needs one card per client)."""
    import shlex

    text = (REPO / "scripts" / name).read_text().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines() if "python -m feddat_tpu.cli" in ln)
    line = re.sub(r"\$\{\w+:-([^}]*)\}", r"\1", line.split("python -m feddat_tpu.cli", 1)[1])
    argv = [a for a in shlex.split(line) if a != "$@"]
    if "--engine" not in argv or engine:
        return argv
    i = argv.index("--engine")
    check(argv[i + 1] == "spmd", f"{name}: unexpected engine {argv[i + 1]}")
    return argv[:i] + argv[i + 2:]


def launch_cli(label, argv, log, timeout=600):
    """``python -m feddat_tpu_torch.cli`` in a process of its own, from the
    checkout -> (exit code, seconds to its exit, start time on this clock,
    its stderr and stdout)."""
    import os

    env = dict(os.environ, PYTHONPATH=str(REPO))
    t0 = time.time()
    with open(log, "w") as out:
        rc = subprocess.run([sys.executable, "-m", "feddat_tpu_torch.cli", *argv], cwd=REPO, env=env,
                            stdout=out, stderr=subprocess.STDOUT, timeout=timeout).returncode
    wall = time.time() - t0
    text = Path(log).read_text()
    print(f"cli: {label}: exit {rc} after {wall:.2f} s")
    if rc != 0:
        print("\n".join(f"cli: {label} | {ln}" for ln in text.splitlines()[-40:]))
    return rc, wall, t0, text


def cli_outputs(out_dir, run_name):
    """-> (history, metrics records) of a CLI run."""
    history = json.loads((Path(out_dir) / f"{run_name}.history.json").read_text())
    records = [json.loads(ln) for ln in (Path(out_dir) / f"{run_name}.metrics.jsonl").read_text()
               .splitlines()]
    return history, records


def cli_stages(label, t0, text):
    """The launch's own log lines, each at its seconds after the launch
    (the logger's timestamps): where the time to the first step goes."""
    import datetime

    for line in text.splitlines():
        m = re.match(r"(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d),(\d{3}) - feddat_tpu_torch\S* - \w+ - (.*)", line)
        if m:
            at = datetime.datetime.strptime(m.group(1), "%Y-%m-%d %H:%M:%S").timestamp()
            print(f"cli: {label} at {at + int(m.group(2)) / 1e3 - t0:7.2f} s: {m.group(3)[:150]}")


def cli_timeline(label, t0, wall, records):
    """The seconds to the first step and to the exit, each round's wall and
    samples/s (the JSONL's, every step's: --wandb_freq 1)."""
    steps = [r for r in records if r["kind"] == "step"]
    rounds = [r for r in records if r["kind"] == "round"]
    rates = [round(r["samples_per_sec"], 1) for r in steps[1:]]
    print(f"cli: {label}: first step {steps[0]['ts'] - t0:.2f} s after the launch, exit at {wall:.2f} s; "
          f"round walls (run_round, host clock) {[round(r['wall_s'], 3) for r in rounds]} s; "
          f"samples/s from one step record to the next {rates} (each record reads the step's "
          f"losses back; the logger's clock starts at the first step)")


def profile_counts(profile_dir):
    """The one trace file the CLI wrote -> (each wrapper's launches from the
    device's kernel names, graph launches on the host, trace events)."""
    traces = sorted(Path(profile_dir).glob("*.pt.trace.json"))
    check(len(traces) == 1, f"expected one trace in {profile_dir}, found {traces}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    kernels = Counter(e["name"] for e in events if e.get("cat") == "kernel")
    graphs = sum(e.get("name") == "cudaGraphLaunch" for e in events)
    cpu = sum(e.get("cat") == "cpu_op" for e in events)
    timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
    span = max(e["ts"] + e["dur"] for e in timed) - min(e["ts"] for e in timed)
    busy = sum(e["dur"] for e in timed if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    print(f"cli: {traces[0].name}: {len(events)} events ({cpu} CPU ops, {sum(kernels.values())} kernels, "
          f"{graphs} cudaGraphLaunch), {traces[0].stat().st_size / 2 ** 20:.1f} MiB; device busy "
          f"{busy / 1e3:.3f} ms of the trace's {span / 1e3:.3f} ms, idle share {100 * (1 - busy / span):.1f}%")
    return device_launches(kernels), graphs, events


def check_profile(label, profile_dir, steps, captures, layers=12):
    """#1 and #4 in the profile of round 0: two launches per layer per step
    (the ensemble pass and DAT stage 2), for the replayed steps and for each
    capture's warm-up call (a capture itself runs nothing)."""
    dev, graphs, _ = profile_counts(profile_dir)
    want = 2 * layers * (steps + captures)
    print(f"cli: {label}: round 0's profile: #1 {dev['attn_block']}, #4 {dev['layer_block_bwd']} "
          f"device launches over {steps} steps ({graphs} graph replays) and {captures} capture "
          f"warm-ups: {dev['attn_block'] / (steps + captures):.1f} and "
          f"{dev['layer_block_bwd'] / (steps + captures):.1f} per step (want {2 * layers})")
    check(dev["attn_block"] == dev["layer_block_bwd"] == want, f"{label}: profile launches {dev}")
    check(graphs == steps, f"{label}: {graphs} graph replays in round 0, expected {steps}")


def cli_host_batches(torch, root, seed, argv):
    """The CLI's own client builder on (a)'s flags without
    --device_normalize, so that the u8 cache is finalized on the host: host
    ms per batch of TB with the cache cold and warm through the native core,
    warm through the numpy finalize, and the finalize alone; native and numpy
    batches bitwise equal."""
    import numpy as np

    import feddat_tpu_torch.cli as cli
    from feddat_tpu_torch import native
    from feddat_tpu_torch.data.images import VILT_MEAN, VILT_STD, finalize_vilt_u8

    check(native.available(), "the native host core did not build on this machine")
    args = cli.build_parser().parse_args([a for a in argv if a != "--device_normalize"])
    tok = native.NativeWordPiece(disk_tokenizer().vocab)
    clients, _ = cli.build_clients(args, cli.resolve_task_keys(args.ordered_cl_tasks), tok)
    pipe = clients[DISK_TASKS[0]]
    path = cli.image_path(pipe)
    check(pipe._native_finalize is native.finalize_canvas_batch and not pipe.pixels_u8,
          f"the CLI's pipeline does not finalize its u8 cache natively: {path}")
    chunk = pipe.examples[:TB]

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return 1e3 * (time.perf_counter() - t0), out

    cold, _ = timed(lambda: pipe._make_batch(chunk))
    warm, batch = timed(lambda: pipe._make_batch(chunk))
    u8s = [pipe._load_u8(e) for e in chunk]
    fin_native, _ = timed(lambda: native.finalize_canvas_batch(u8s, pipe.canvas, VILT_MEAN.tolist(),
                                                               VILT_STD.tolist(), num_threads=8))
    fin_numpy, _ = timed(lambda: [finalize_vilt_u8(a, pipe.canvas) for a in u8s])
    pipe._native_finalize = None
    warm_numpy, batch_numpy = timed(lambda: pipe._make_batch(chunk))
    same = all(np.array_equal(batch[k], batch_numpy[k]) for k in batch)
    print(f"cli: host ms per batch of {TB} through the CLI's build_clients ({path}; "
          f"canvas {pipe.canvas}): cache cold {cold:.1f}, warm {warm:.1f} (native finalize), warm "
          f"{warm_numpy:.1f} (numpy finalize); the finalize alone {fin_native:.1f} native vs "
          f"{fin_numpy:.1f} numpy; native and numpy batches bitwise equal: {same}")
    check(same, "the native finalize's batch differs from numpy's")


def cli_vilt_serving(torch, root, seed, ckpt):
    """``ViltVqaPredictor.from_checkpoint`` on the CLI's ``meta.json`` and
    last round: "block" with the fused adapter (#1, #2) against the plain
    route, within 5% of the largest probability, for each task of the run."""
    from feddat_tpu_torch.configs.core import PEFTMode
    from feddat_tpu_torch.models import create_model
    from feddat_tpu_torch.models.vilt import TaskHeadSpec
    from feddat_tpu_torch.serving import ViltVqaPredictor
    from feddat_tpu_torch.utils.checkpointing import load_meta

    meta = load_meta(ckpt)
    heads = {k: TaskHeadSpec(**v) for k, v in meta["heads"].items()}

    def model(attn_impl, fused):
        return create_model("vilt", heads, PEFTMode.DAT, meta["adapter_reduction_factor"], meta["dtype"],
                            image_size=tuple(meta["image_size"]), attn_impl=attn_impl,
                            attention_logits_dtype=meta["attention_logits_dtype"],
                            adapter_fused=fused, seed=seed + 5)[0]

    tok = disk_tokenizer()
    served, plain = model("block", True), model("auto", False)
    for task in meta["tasks"]:
        _, evals, backend, a2l = disk_split(root, task)
        label2ans = [None] * heads[task].num_labels
        for answer, j in a2l.items():
            label2ans[j] = answer
        imgs, qs = [backend.load(e.image_id) for e in evals], [e.question for e in evals]
        pred = ViltVqaPredictor.from_checkpoint(ckpt, tok, label2ans, task_key=task, model=served,
                                                batch_size=B)
        ref = ViltVqaPredictor.from_checkpoint(ckpt, tok, label2ans, task_key=task, model=plain,
                                               batch_size=B)
        reset_counts()
        answers = pred.predict(imgs, qs, top_k=1)
        torch.cuda.synchronize()
        counts = read_counts()
        want = {**NO_LAUNCHES, "attn_block": 12 * len(imgs) // B, "adapter_fused": 12 * len(imgs) // B}
        batch = pred._preprocess(imgs[:B], qs[:B])
        probs, probs_plain = pred.forward(batch), ref.forward(batch)
        diff, top = float(abs(probs - probs_plain).max()), float(probs_plain.max())
        print(f"cli: ViltVqaPredictor.from_checkpoint {task} ('block', fused adapter, recipe "
              f"{meta['dtype']}, logits {meta['attention_logits_dtype']}): {len(answers)} answers, "
              f"launches {counts_text(counts)}; against the plain route max_abs_diff {diff:.3e} "
              f"(tol {0.05 * top:.3e}, 5% of max prob {top:.3e}); first answer {answers[0]}")
        check(counts == want, f"from_checkpoint launches {counts}, expected {want}")
        check(diff <= 0.05 * top, f"{task}: the served kernel route disagrees with the plain route")


def cli_albef_serving(torch, root, seed, ckpt):
    """``AlbefVqaPredictor.from_checkpoint`` on the CLI's ALBEF recipe (its
    answer list) ranking on "flash" (#7, 54 launches per rank_answer)."""
    from feddat_tpu_torch.configs.core import PEFTMode
    from feddat_tpu_torch.models import create_model
    from feddat_tpu_torch.serving import AlbefVqaPredictor
    from feddat_tpu_torch.utils.checkpointing import load_meta

    meta = load_meta(ckpt)
    task = meta["tasks"][0]
    model = create_model(meta["encoder_name"], {}, PEFTMode(meta["optimizer_mode"]),
                         meta["adapter_reduction_factor"], meta["dtype"], attn_impl="flash",
                         attention_logits_dtype=meta["attention_logits_dtype"], seed=None)[0]
    pred = AlbefVqaPredictor.from_checkpoint(ckpt, disk_tokenizer(), model=model, batch_size=AB,
                                             k=ALBEF_K, max_question_len=LQ, max_answer_len=LA)
    _, evals, backend, _ = disk_split(root, task)
    imgs, qs = [backend.load(e.image_id) for e in evals[:2 * AB]], [e.question for e in evals[:2 * AB]]
    reset_counts()
    answers = pred.predict(imgs, qs, top_k=3)
    torch.cuda.synchronize()
    counts = read_counts()
    bank = meta["answer_lists"][task]
    print(f"cli: AlbefVqaPredictor.from_checkpoint {task} ('flash', a {len(bank)}-answer bank from "
          f"meta.json, k={ALBEF_K}): {len(answers)} answers, launches {counts_text(counts)}; first "
          f"answer {answers[0]}")
    check(pred.answer_list == bank and len(bank) >= ALBEF_K, "the recipe's answer list was not taken")
    check(counts == {**NO_LAUNCHES, "flash_attention": 54 * len(imgs) // AB},
          f"ALBEF from_checkpoint launches {counts}")
    check(all(a in bank for ans in answers for a, _ in ans), "an answer outside the bank")


def cli_refusals(work, common):
    """A launch that exits non-zero before any model is built: two clients of
    the SPMD engine on one card (JAX's mesh error), in a process of its own."""
    flags = ["--engine", "spmd", "--ordered_cl_tasks", CLI_TASKS, "--mesh_data", "1"]
    out = work / "refused"
    rc, wall, _, text = launch_cli(" ".join(flags), ["--encoder_name", "vilt", "--output_dir", str(out),
                                                     *common, *flags], work / "refused.log", 120)
    print(f"cli: refused {' '.join(flags)} in {wall:.2f} s: {text.strip().splitlines()[-1]}")
    check(rc != 0 and "ValueError: need 2 devices, have 1" in text and not out.exists()
          and "params:" not in text, f"{flags} was not refused up front")


def cli_fp32_lora(torch, work, common):
    """ViLT-B/32 LoRA in float32 on "fused" through ``cli.main``, one client,
    one round: it exits 0, writes the task's score and launches #5/#6 (read
    around the call, graphs on: one count per call made)."""
    import logging

    from feddat_tpu_torch import cli

    flags = ["--dtype", "float32", "--attn_impl", "fused", "--optimizer_mode", "lora"]
    out = work / "fp32_lora"
    argv = ["--encoder_name", "vilt", "--output_dir", str(out), *common, *flags, "--ordered_cl_tasks",
            DISK_TASKS[0], "--comm_rounds", "1", "--batch_size", str(TB)]
    logger = logging.getLogger("feddat_tpu_torch")
    handlers = list(logger.handlers)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    try:
        rc = cli.main(argv)
    finally:  # the handler of the run's log file goes with its directory
        for h in [h for h in logger.handlers if h not in handlers]:
            logger.removeHandler(h)
            h.close()
    torch.cuda.synchronize()
    got = read_counts()
    history = json.loads(next(out.glob("*.history.json")).read_text())
    print(f"cli: {' '.join(flags)}, one client, one round, through cli.main: returned {rc} after "
          f"{time.perf_counter() - t0:.2f} s; launches {counts_text(got)}; history {history}")
    check(rc in (None, 0) and got["fused_attention"] > 0 and got["fused_attention_bwd"] > 0
          and sum(got.values()) == got["fused_attention"] + got["fused_attention_bwd"],
          f"the float32 LoRA launch on 'fused': {rc}, {got}")
    check([e["round"] for e in history] == [0] and math.isfinite(history[0]["scores"][DISK_TASKS[0]]),
          f"the float32 LoRA launch's history {history}")
    gc.collect()
    torch.cuda.empty_cache()


def cli_spmd(torch, work, common, task, sequential_ckpt):
    """The tuned ViLT script as it is, ``--engine spmd``, on one client (one
    card: a world of one over NCCL) for one round, unprofiled: exit 0, the
    three DAT scores, the budget line, JAX's checkpoint layout (the stacked
    client bank), and round 0 bitwise the profiled sequential launch's in
    ``sequential_ckpt`` (the same client and seed; its head ``task_<task>``
    is the SPMD engine's ``task_fed``)."""
    ckpt, out = work / "spmd_ckpt", work / "spmd_logs"
    argv = script_flags("train_vilt_tpu_tuned.sh", engine=True) + common + [
        "--ordered_cl_tasks", task, "--comm_rounds", "1", "--checkpoint_dir", str(ckpt),
        "--output_dir", str(out)]
    rc, wall, t0, text = launch_cli("ViLT tuned flags as they are (--engine spmd), 1 client, 1 round",
                                    argv, work / "spmd.log")
    check(rc == 0 and "--engine" in argv, "the --engine spmd launch failed")
    history, records = cli_outputs(out, f"vilt_dat_bs{TB}_lr0.0001_rounds1x1_seed1")
    cli_timeline("ViLT spmd", t0, wall, records)
    spmd = torch.load(ckpt / "round_00000", map_location="cpu", weights_only=True)
    seq = torch.load(Path(sequential_ckpt) / "round_00000", map_location="cpu", weights_only=True)
    stacked = spmd["personal"]["stacked_clients"]
    got = {**spmd["server_params"], **{k: v[0] for k, v in stacked.items()}}
    want = {k.replace(f"task_{task}.", "task_fed."): v
            for k, v in {**seq["server_params"], **seq["personal"][task]}.items()}
    bad = [k for k in want if k not in got or not torch.equal(got[k], want[k])]
    print(f"cli: ViLT spmd history {history}; {[ln.split(' - ')[-1] for ln in text.splitlines() if 'kernel launches' in ln]}; "
          f"checkpoint: {len(spmd['server_params'])} backbone tensors, {len(stacked)} stacked client "
          f"tensors; round 0 against the profiled sequential launch's: {len(bad)} of {len(want)} "
          f"tensors differ (bitwise rule)")
    check("(x1 clients stacked)" in text and [e["round"] for e in history] == [0]
          and len(history[0]["scores"][task]) == 3, "the spmd launch's history or budget line")
    check(set(spmd["personal"]) == {"stacked_clients"} and all(v.shape[0] == 1 for v in stacked.values()),
          "the spmd checkpoint is not JAX's stacked client bank")
    check(not bad and set(got) == set(want) and torch.equal(spmd["rng"], seq["rng"]),
          f"the spmd launch's round 0 differs from the sequential launch's: {bad[:4]}")
    shutil.rmtree(ckpt)


def phase_cli(torch, seed, root):
    """Phase 13 (see the module docstring): the launch surface, ``python -m
    feddat_tpu_torch.cli`` in processes of its own on phase 12's dataset."""
    import os

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    work = Path(root) / "cli"
    work.mkdir()
    vocab = str(REPO / "tests" / "fixtures" / "vocab30k.txt")
    common = ["--climb_data_dir", root, "--vocab_file", vocab, "--splits", *CLI_SPLITS,
              "--eval_every", "1", "--wandb_freq", "1"]

    cli_refusals(work, common)
    cli_fp32_lora(torch, work, common)

    # (a) ViLT-B/32 DAT, the tuned script's flags on the sequential engine,
    # one client (the SPMD launch below takes the same one on one card)
    task = DISK_TASKS[0]
    vilt = script_flags("train_vilt_tpu_tuned.sh") + common + ["--ordered_cl_tasks", task]
    cli_host_batches(torch, root, seed, vilt)
    ckpt, profile, out = work / "vilt_ckpt", work / "vilt_profile", work / "vilt_logs"
    argv = vilt + ["--comm_rounds", str(CLI_ROUNDS), "--checkpoint_dir", str(ckpt),
                   "--profile_dir", str(profile), "--output_dir", str(out)]
    rc, wall, t0, text = launch_cli("ViLT tuned flags, sequential, 2 rounds, profiled", argv,
                                    work / "vilt.log")
    check(rc == 0, "the ViLT launch failed")
    run_name = f"vilt_dat_bs{TB}_lr0.0001_rounds{CLI_ROUNDS}x1_seed1"
    history, records = cli_outputs(out, run_name)
    cli_stages("ViLT", t0, text)
    cli_timeline("ViLT", t0, wall, records)
    print(f"cli: ViLT history {history}; {[ln.split(' - ')[-1] for ln in text.splitlines() if 'kernel launches' in ln]}")
    check([e["round"] for e in history] == list(range(CLI_ROUNDS))
          and all(len(e["scores"][task]) == 3 for e in history),
          "the ViLT history lacks the task's three DAT scores")
    check({r["kind"] for r in records} == {"run_start", "step", "round"}, "JSONL record kinds")
    check("u8 cache, normalized on the card" in text and "using native C++ WordPiece" in text,
          "the launch did not take the u8 cache or the native tokenizer")
    check_profile("ViLT", profile, DISK_TRAIN // TB, captures=1)

    # (d) the same script as it is, --engine spmd, unprofiled: round 0
    # bitwise (a)'s (profiling and the engine change nothing)
    cli_spmd(torch, work, common, task, ckpt)
    cli_vilt_serving(torch, root, seed, str(ckpt))
    shutil.rmtree(ckpt)

    # (b) ALBEF, the tuned script's flags, one task, one round
    ckpt, profile, out = work / "albef_ckpt", work / "albef_profile", work / "albef_logs"
    albef = script_flags("train_albef_tpu_tuned.sh") + common + [
        "--ordered_cl_tasks", DISK_TASKS[0], "--comm_rounds", "1", "--debug", "2",
        "--checkpoint_dir", str(ckpt), "--profile_dir", str(profile), "--output_dir", str(out)]
    rc, wall, t0, text = launch_cli("ALBEF tuned flags, 1 round, profiled", albef, work / "albef.log")
    check(rc == 0, "the ALBEF launch failed")
    history, records = cli_outputs(out, f"albef_no_distill_dat_bs{ATB}_lr0.0001_rounds1x1_seed2")
    cli_stages("ALBEF", t0, text)
    cli_timeline("ALBEF", t0, wall, records)
    print(f"cli: ALBEF history {history}; {[ln.split(' - ')[-1] for ln in text.splitlines() if 'kernel launches' in ln]}")
    check(history[-1]["round"] == 0 and len(history[-1]["scores"][DISK_TASKS[0]]) == 3,
          "the ALBEF history lacks its DAT scores")
    check_profile("ALBEF", profile, DISK_TRAIN // ATB, captures=1)
    meta = json.loads((ckpt / "meta.json").read_text())
    check(len(meta["answer_lists"][DISK_TASKS[0]]) >= ALBEF_K, f"meta answer_lists {meta.get('answer_lists')}")
    cli_albef_serving(torch, root, seed, str(ckpt))
    shutil.rmtree(work)
    print(f"cli: phase took {time.perf_counter() - t_phase:.1f} s")


# Phase 14: every training mode of the sequential engine.  ALBEF momentum
# distillation in adapter mode (the EMA written in place into the twin the
# compiled step keeps on the card, then the twin's forward and the model's),
# visual prompts on ALBEF (the fusion cross-attention at 577 + 5 keys), the
# joint DAT step on ViLT (one mega-batch pass of 2B rows through the "block"
# way), the ViLT modes adapter, none and freeze_encoder on "fused", and an
# albef_distill CLI launch.
MODE_STEPS_PER_EPOCH = 4  # the alpha ramp's epoch: 0, 0.1, 0.2, 0.3, then 0.4
MODES_SPEED_ROUNDS = 1
# ALBEF's batch in this phase (questions, A=4 answers each): a mode's
# mechanics, launches and gradient rule do not depend on it, and its eager
# steps at the ALBEF phases' 48 took most of the phase
MODES_AB = 16
VILT_MODES = ("adapter", "none", "freeze_encoder")


def alpha_batch(torch, batch, i):
    """The batch of step ``i`` of epoch 0 with ``add_alpha``'s alpha on the
    card, as the engine hands it to a step."""
    from feddat_tpu_torch.train.forwards import add_alpha, to_device

    return to_device(add_alpha(batch, 0, i, MODE_STEPS_PER_EPOCH), torch.device("cuda"))


def albef_plain_step(torch, model, params, seed, mode="adapter", distill=True):
    """(the plain step of ``mode`` with the distill forward, or the
    no-distill one, its initial state from ``seed``, its partitioner); the
    distill state's twin starts as the parameters (``aux_init``)."""
    from feddat_tpu_torch.configs.core import OptimizerConfig, PEFTMode
    from feddat_tpu_torch.train import dat
    from feddat_tpu_torch.train.forwards import make_albef_distill_forward, make_albef_forward

    opt = OptimizerConfig()
    part = dat.Partitioner(params, "fed", PEFTMode(mode))
    forward = (make_albef_distill_forward if distill else make_albef_forward)(model)
    step = dat.make_plain_train_step(forward, part, opt, 10_000, "adapter" if mode == "adapter" else "none",
                                     aux_forward=distill)
    state0 = dat.init_train_state(params, part, opt, torch.Generator().manual_seed(seed))
    return step, state0.replace(aux=dict(params)) if distill else state0, part


def host_copy(tensors):
    """fp32 numpy copies on the host (never views of the tensors)."""
    import numpy as np

    return {k: np.array(v.detach().float().cpu().numpy()) for k, v in tensors.items()}


def twin_ema_check(torch, label, before_twin, before_params, after_twin):
    """The twin after a step against a host fp32 recompute of JAX's
    expression from the twin and the parameters before it: bitwise, every
    tensor, frozen ones included."""
    import numpy as np

    m, keep = np.float32(0.995), np.float32(1.0 - 0.995)
    bad = [k for k, t in before_twin.items()
           if not np.array_equal(after_twin[k].cpu().numpy(), t * m + before_params[k] * keep)]
    moved = sum(not np.array_equal(before_twin[k], after_twin[k].cpu().numpy()) for k in before_twin)
    print(f"modes: {label}: the twin's EMA against a host fp32 recompute: {len(before_twin)} tensors, "
          f"{len(bad)} differ{'' if not bad else ' e.g. ' + bad[0]}; {moved} moved")
    check(not bad and moved > 0, f"{label}: the twin's EMA is not m*0.995 + p*0.005: {bad[:3]}")


def alternating_speed(torch, makers, batch_size, rounds=MODES_SPEED_ROUNDS):
    """Samples/s and own peak memory of steps with graphs on, in
    ``rounds`` rounds whose order alternates: in each round every path is
    built by ``makers[name]() -> (step, state0, batch)``, captured, timed in
    2 samples of 2 replayed steps and freed (one path's graph alive at a
    time) -> {name: (samples/s median, samples, own peak reserved GiB, own
    peak allocated GiB)}, the peaks above what was resident at the path's
    start."""
    times = {name: [] for name in makers}
    peak = {name: (0.0, 0.0) for name in makers}
    names = list(makers)
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = (torch.cuda.memory_reserved(), torch.cuda.memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            step, state, batch = makers[name]()
            state, _ = step(state, batch)  # capture
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(2):
                    state, _ = step(state, batch)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) / 2)
            own = ((torch.cuda.max_memory_reserved() - base[0]) / 2 ** 30,
                   (torch.cuda.max_memory_allocated() - base[1]) / 2 ** 30)
            peak[name] = (max(peak[name][0], own[0]), max(peak[name][1], own[1]))
            del step, state, batch
    torch.cuda.empty_cache()
    return {name: (batch_size / statistics.median(times[name]),
                   [round(batch_size / t, 1) for t in times[name]], *peak[name]) for name in makers}


def modes_distill(torch, seed):
    """(a) albef_distill, adapter mode, "flash", B=16 x 4, dropout 0.1 live:
    eager and replayed steps bitwise, the twin's EMA against the host, one
    capture while alpha ramps, launches from the device, host launches and
    samples/s and peak memory against the no-distill step, the gradients with
    dropout off by the 2x-bf16 rule, and a 2-client round -> the launches per
    replayed step measured on the device."""
    import numpy as np

    from feddat_tpu_torch.configs.core import FederatedConfig, OptimizerConfig, PEFTMode, TrainConfig
    from feddat_tpu_torch.data.synthetic import SyntheticAlbefClient
    from feddat_tpu_torch.federated.engine import FederatedTrainer
    from feddat_tpu_torch.train import compiled
    from feddat_tpu_torch.train.forwards import make_albef_distill_forward
    from feddat_tpu_torch.train.trainers import resolve_trainer
    from feddat_tpu_torch.utils.seeding import stage_generator

    t_lap = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        print(f"modes: distillation, {what} took {now - t_lap[0]:.1f} s")
        t_lap[0] = now

    model = albef_train_model(torch, seed, "flash", encoder="albef_distill", mode="adapter")
    cfg = model.cfg
    check(cfg.distill and cfg.adapter.names == ("adapter",) and cfg.momentum == 0.995,
          f"unexpected albef_distill config {cfg}")
    vit, text = cfg.vision_layers, cfg.bert.fusion_layer
    fusion, dec = cfg.bert.num_layers - text, cfg.decoder_layers
    params = {n: t.detach() for n, t in model.state_dict().items()}
    batch = albef_train_batch(torch, MODES_AB, seed)
    step, state0, part = albef_plain_step(torch, model, params, seed)
    # the twin's forward and the model's run the 12 ViT sites on #7 (the BERT
    # sites carry attention dropout); only the model's has a backward, and
    # block 0's attention input depends on no trainable parameter
    want = {**NO_LAUNCHES, "flash_attention": 2 * vit, "flash_attention_bwd_dq": vit - 1,
            "flash_attention_bwd_dkv": vit - 1}

    # eager: two chained steps, the launches of each
    with graph_mode(False):
        torch.cuda.synchronize()
        reset_counts()
        e1, em1 = step(state0, alpha_batch(torch, batch, 0))
        torch.cuda.synchronize()
        counts = read_counts()
        etwin1 = host_copy(e1.aux)  # handed back, so the next step updates it in place
        e2, em2 = step(e1, alpha_batch(torch, batch, 1))
        torch.cuda.synchronize()
    print(f"modes: albef_distill plain step, adapter mode, dropout 0.1 live, attn_impl='flash', "
          f"B={MODES_AB} A={ANS_PER_Q}: #7/#8/#9 launches {flash_launches(counts)} (expected "
          f"{flash_launches(want)}: the ViT sites of the twin's forward and the model's, the "
          f"model's backward but block 0); losses {float(em1['loss']):.4f}, {float(em2['loss']):.4f} "
          f"at alpha 0 and {float(alpha_batch(torch, batch, 1)['alpha']):.2f}")
    check(counts == want, f"distill step launches {counts}, expected {want}")
    check(all(math.isfinite(float(m["loss"])) for m in (em1, em2)), "non-finite distill loss")

    # graphs: the same two steps, bitwise; the twin resident, its EMA against
    # the host; one capture while alpha ramps over two more steps
    cap0 = compiled.STATS["captures"]
    g1, gm1 = step(state0, alpha_batch(torch, batch, 0))
    torch.cuda.synchronize()
    twin1, params1 = host_copy(g1.aux), host_copy(g1.params)
    g2, gm2 = step(g1, alpha_batch(torch, batch, 1))
    torch.cuda.synchronize()
    twin_ema_check(torch, "distill step 2 (replayed)", twin1, params1, g2.aux)
    trained = sorted(part.shared_paths | part.head_paths)
    bad = [f"{i}/{what}/{k}" for i, (e, g, em, gm, etwin, twin) in enumerate(
        ((e1, g1, em1, gm1, etwin1, twin1), (e2, g2, em2, gm2, host_copy(e2.aux), host_copy(g2.aux))))
        for what, k, a, b in ([("loss", "", em["loss"].cpu(), gm["loss"].cpu())]
                              + [("params", k, e.params[k].cpu(), g.params[k].cpu()) for k in trained]
                              + [("twin", k, torch.from_numpy(etwin[k]), torch.from_numpy(twin[k]))
                                 for k in twin])
        if not torch.equal(a.float(), b.float())]
    resident = all(g2.aux[k] is g1.aux[k] and g1.aux[k] is not params[k] for k in params)
    for i in (2, 3):
        g2, _ = step(g2, alpha_batch(torch, batch, i))
    torch.cuda.synchronize()
    captures = compiled.STATS["captures"] - cap0
    print(f"modes: distill steps replayed against eager: {len(bad)} of the losses, {len(trained)} "
          f"trained tensors and {len(params)} twin tensors of 2 steps differ (bitwise rule); the twin "
          f"handed back as the program's own tensors: {resident}; {captures} capture(s) over 4 steps "
          f"with alpha 0, 0.1, 0.2, 0.3")
    check(not bad, f"distill replays differ from eager steps: {bad[:3]}")
    check(resident and captures == 1 and len(step.program.entries) == 1,
          f"the twin is not resident ({resident}) or alpha made captures ({captures})")
    del e1, e2, em1, em2, etwin1, twin1, params1, state0
    lap("the model and eager against replayed steps")

    # device-measured launches, host launches per replay with and without distillation
    label = f"albef_distill plain step (adapter, flash, dropout live, B={MODES_AB}x{ANS_PER_Q})"
    held = [g2]  # each call takes the state the last one returned: its twin is donated

    def distill_call():
        held[0], _ = step(held[0], alpha_batch(torch, batch, 4))

    replay = graph_vs_eager(torch, label, distill_call, want)
    step_nd, state_nd, _ = albef_plain_step(torch, model, params, seed, distill=False)
    want_nd = {**NO_LAUNCHES, "flash_attention": vit, "flash_attention_bwd_dq": vit - 1,
               "flash_attention_bwd_dkv": vit - 1}
    replay_launches(torch, "the same step without distillation (albef_no_distill forward)",
                    lambda: step_nd(state_nd, batch), want_nd)
    del step, step_nd, g1, g2, gm1, gm2, state_nd, held
    torch.cuda.empty_cache()
    lap("graph against eager and the replay without distillation")


    # dropout off: the distill step's gradients by the 2x-bf16 rule
    sd = model.state_dict()

    def distill_grads(m):
        fwd = make_albef_distill_forward(m)
        leaves = {k: params[k].detach().requires_grad_() for k in trained}
        twin = {k: v.clone() for k, v in params.items()}
        gens = (stage_generator(seed + 1, "cuda"), stage_generator(seed + 2, "cuda"))
        loss, _, _ = fwd({**params, **leaves}, alpha_batch(torch, batch, 2), "adapter", gens, twin)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return {"loss": loss.detach(), "grads": {"trainable": dict(zip(leaves, grads))}}

    off = albef_train_model(torch, seed, "flash", dropout=False, state=sd, encoder="albef_distill",
                            mode="adapter")
    torch.cuda.synchronize()
    reset_counts()
    kernel = distill_grads(off)
    torch.cuda.synchronize()
    off_counts = read_counts()
    per_pass = vit + text + 2 * fusion + 2 * dec
    want_off = {**NO_LAUNCHES, "flash_attention": 2 * per_pass, "flash_attention_bwd_dq": per_pass - 3,
                "flash_attention_bwd_dkv": per_pass - 3}
    print(f"modes: distill step, dropout off: #7/#8/#9 launches {flash_launches(off_counts)} "
          f"(expected {flash_launches(want_off)}: {per_pass} sites in each forward, the backward but "
          f"ViT block 0, text layer 0 self and decoder layer 0 self)")
    check(off_counts == want_off, f"distill dropout-off launches {off_counts}, expected {want_off}")
    del off
    before = read_counts()
    plain = albef_train_model(torch, seed, "auto", dropout=False, state=sd, encoder="albef_distill",
                              mode="adapter")
    plain_m = distill_grads(plain)
    del plain
    torch.cuda.empty_cache()
    exact = albef_train_model(torch, seed, "auto", "float32", dropout=False, state=sd,
                              encoder="albef_distill", mode="adapter")
    exact_m = distill_grads(exact)
    del exact
    torch.cuda.synchronize()
    check(read_counts() == before, "the plain path launched a kernel")
    grad_agreement(torch, f"albef_distill plain step, dropout off, B={MODES_AB}", kernel, plain_m, exact_m,
                   ("loss",))
    del kernel, plain_m, exact_m
    torch.cuda.empty_cache()
    lap("the gradients with dropout off")

    # a 2-client round through FederatedTrainer with the distill hooks, graphs on
    clients = {k: SyntheticAlbefClient(k, num_train=2 * MODES_AB, num_eval=MODES_AB, num_answers=len(ALBEF_ANSWERS),
                                       vocab_size=30522, question_len=LQ, answer_len=LA,
                                       max_answers_per_q=ANS_PER_Q, image_size=(ARES, ARES),
                                       batch_size=MODES_AB, val_batch_size=MODES_AB, seed=seed + 1 + i)
               for i, k in enumerate(TRAIN_CLIENTS)}
    hooks = resolve_trainer("albef_distill", "vqa", rank_k=ALBEF_K, answer_banks={
        k: (c.answer_ids, c.answer_mask) for k, c in clients.items()})
    tcfg = TrainConfig(encoder_name="albef_distill", peft_mode=PEFTMode.ADAPTER,
                       optimizer=OptimizerConfig(),
                       federated=FederatedConfig(comm_rounds=1, local_epochs=1, eval_every=1),
                       num_epochs=1, seed=seed)
    trainer = FederatedTrainer(model, params, clients, tcfg, make_forward=hooks.make_forward,
                               make_eval=hooks.make_eval, aux_init=hooks.aux_init,
                               batch_transform=hooks.batch_transform, aux_forward=hooks.aux_forward)
    cap0 = compiled.STATS["captures"]
    reset_counts()
    t0 = time.perf_counter()
    trainer.run_round(0)
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    round_launches, captures = read_counts(), compiled.STATS["captures"] - cap0
    entry = trainer.evaluate_round(0)
    steps = 2 * len(clients)
    print(f"modes: FederatedTrainer albef_distill round of {len(clients)} clients x 2 plain steps "
          f"(alpha 0 and 0.2) in {round_s:.2f} s, {captures} capture(s) for {len(trainer._programs)} "
          f"programs, #7/#8/#9 launches {flash_launches(round_launches)}; evaluate {entry['scores']}")
    check(captures == 1, f"the distill round captured {captures} graphs, expected 1 (one shared program)")
    check(round_launches == {k: steps * v for k, v in want.items()}, f"round launches {round_launches}")
    for key, score in entry["scores"].items():
        check(math.isfinite(score) and 0.0 <= score <= 100.0, f"bad evaluate score for {key}: {score}")
    moved = [k for k, v in trainer.server_params.items() if not torch.equal(v, params[k])]
    check(moved and all(".adapter." in k for k in moved), f"the round moved {moved[:3]}")
    del trainer, clients
    torch.cuda.empty_cache()
    return replay


def modes_prompt(torch, seed, root):
    """(b) prompt tuning on ALBEF ("flash", dropout off, so the fusion
    cross-attention runs #7-#9 at 577 + 5 keys): one plain step with its
    launches, its gradients by the 2x-bf16 rule, a round with a checkpoint,
    and ``from_checkpoint`` ranking on "flash", bitwise a predictor from the
    trainer's parameters."""
    from feddat_tpu_torch.configs.core import FederatedConfig, OptimizerConfig, PEFTMode, TrainConfig
    from feddat_tpu_torch.data.synthetic import SyntheticAlbefClient
    from feddat_tpu_torch.federated.engine import FederatedTrainer
    from feddat_tpu_torch.models import create_model
    from feddat_tpu_torch.serving import AlbefVqaPredictor
    from feddat_tpu_torch.train.forwards import make_albef_forward
    from feddat_tpu_torch.train.trainers import resolve_trainer
    from feddat_tpu_torch.utils.checkpointing import write_meta
    from feddat_tpu_torch.utils.seeding import stage_generator

    model = albef_train_model(torch, seed, "flash", dropout=False, mode="prompt")
    cfg = model.cfg
    check(cfg.prompt.enabled and cfg.prompt.length == 5 and not cfg.adapter.names,
          f"unexpected prompt config {cfg}")
    vit, text = cfg.vision_layers, cfg.bert.fusion_layer
    fusion, dec = cfg.bert.num_layers - text, cfg.decoder_layers
    params = {n: t.detach() for n, t in model.state_dict().items()}
    batch = albef_train_batch(torch, MODES_AB, seed)
    step, state0, part = albef_plain_step(torch, model, params, seed, mode="prompt", distill=False)
    # the prompt enters the fusion layers' cross-attention keys, so the
    # backward runs there, in the fusion self-attention above the first
    # fusion layer and in the decoder but its first self-attention
    want = {**NO_LAUNCHES, "flash_attention": vit + text + 2 * fusion + 2 * dec,
            "flash_attention_bwd_dq": 2 * fusion - 1 + 2 * dec - 1,
            "flash_attention_bwd_dkv": 2 * fusion - 1 + 2 * dec - 1}
    with graph_mode(False):
        torch.cuda.synchronize()
        reset_counts()
        s1, m1 = step(state0, batch)
        torch.cuda.synchronize()
        counts = read_counts()
    # the first step's lr is 0 (warm-up): its gradients show in Adam's moments
    mu = s1.opt_states["trainable"].mu
    reached = sorted(k for k in mu if bool(mu[k].abs().max() > 0))
    print(f"modes: ALBEF prompt plain step, dropout off, B={MODES_AB} A={ANS_PER_Q} (the fusion "
          f"cross-attention at {VIT_S} + {cfg.prompt.length} keys): #7/#8/#9 launches "
          f"{flash_launches(counts)} (expected {flash_launches(want)}); loss {float(m1['loss']):.4f}; "
          f"gradients reached {len(reached)} of {len(mu)} trainable tensors")
    check(counts == want, f"prompt step launches {counts}, expected {want}")
    check(math.isfinite(float(m1["loss"])) and set(reached) == set(mu)
          and any(k.startswith("prompt_vis.") for k in mu), "the prompt step's gradients")
    del step, s1, m1
    torch.cuda.empty_cache()

    # the step's gradients by the 2x-bf16 rule against the plain paths
    trained = sorted(part.shared_paths | part.head_paths)

    def prompt_grads(m):
        leaves = {k: params[k].detach().requires_grad_() for k in trained}
        loss, _ = make_albef_forward(m)({**params, **leaves}, batch, "none",
                                        stage_generator(seed + 1, "cuda"))
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return {"loss": loss.detach(), "grads": {"trainable": dict(zip(leaves, grads))}}

    torch.cuda.synchronize()
    reset_counts()
    kernel = prompt_grads(model)
    torch.cuda.synchronize()
    check(read_counts() == want, f"prompt gradients' launches {read_counts()}, expected {want}")
    sd = model.state_dict()
    before = read_counts()
    plain_m = prompt_grads(albef_train_model(torch, seed, "auto", dropout=False, state=sd, mode="prompt"))
    torch.cuda.empty_cache()
    exact_m = prompt_grads(albef_train_model(torch, seed, "auto", "float32", dropout=False, state=sd,
                                             mode="prompt"))
    torch.cuda.synchronize()
    check(read_counts() == before, "the plain path launched a kernel")
    grad_agreement(torch, f"ALBEF prompt plain step, dropout off, B={MODES_AB} (fusion cross-attention at "
                   f"{VIT_S + cfg.prompt.length} keys)", kernel, plain_m, exact_m, ("loss",))
    del kernel, plain_m, exact_m, sd
    torch.cuda.empty_cache()

    # one client, one round of 2 steps with a checkpoint; the run recipe as the CLI writes it
    task = DISK_TASKS[0]
    clients = {task: SyntheticAlbefClient(task, num_train=2 * MODES_AB, num_eval=MODES_AB,
                                          num_answers=len(ALBEF_ANSWERS), vocab_size=30522,
                                          question_len=LQ, answer_len=LA, max_answers_per_q=ANS_PER_Q,
                                          image_size=(ARES, ARES), batch_size=MODES_AB, val_batch_size=MODES_AB,
                                          seed=seed + 3)}
    hooks = resolve_trainer("albef_no_distill", "vqa", rank_k=ALBEF_K, answer_banks={
        task: (clients[task].answer_ids, clients[task].answer_mask)})
    tcfg = TrainConfig(encoder_name="albef_no_distill", peft_mode=PEFTMode.PROMPT,
                       optimizer=OptimizerConfig(),
                       federated=FederatedConfig(comm_rounds=1, local_epochs=1, eval_every=1),
                       num_epochs=1, seed=seed)
    ckpt = Path(root) / "modes_prompt_ckpt"
    trainer = FederatedTrainer(model, params, clients, tcfg, make_forward=hooks.make_forward,
                               make_eval=hooks.make_eval, checkpoint_dir=str(ckpt))
    trainer.run_round(0)
    trainer.save_checkpoint(0)
    write_meta(str(ckpt), {"encoder_name": "albef_no_distill", "optimizer_mode": "prompt",
                           "adapter_reduction_factor": 16, "dtype": "bfloat16", "engine": "sequential",
                           "tasks": [task], "smoke": False, "image_size": None,
                           "attention_logits_dtype": "float32", "heads": {},
                           "answer_lists": {task: list(ALBEF_ANSWERS)}})
    tok = disk_tokenizer()
    served = create_model("albef_no_distill", {}, PEFTMode.PROMPT, 16, "bfloat16", attn_impl="flash",
                          seed=None)[0]
    pred = AlbefVqaPredictor.from_checkpoint(str(ckpt), tok, model=served, batch_size=AB, k=ALBEF_K,
                                             max_question_len=LQ, max_answer_len=LA)
    direct = AlbefVqaPredictor(model, trainer._client_params(trainer.clients[0], refresh=False), tok,
                               ALBEF_ANSWERS, batch_size=AB, k=ALBEF_K, max_question_len=LQ,
                               max_answer_len=LA, adapter_mode="none")
    imgs, qs = albef_requests(AB, seed + 4)
    reset_counts()
    got = pred.predict(imgs, qs, top_k=3)
    torch.cuda.synchronize()
    counts = read_counts()
    want_rank = direct.predict(imgs, qs, top_k=3)
    print(f"modes: AlbefVqaPredictor.from_checkpoint of a prompt-mode round ('flash', adapter mode "
          f"{pred.adapter_mode!r}, the cross-attention at {VIT_S + cfg.prompt.length} keys): "
          f"launches {counts_text(counts)}; equal to a predictor from the trainer's parameters: "
          f"{got == want_rank}; first answer {got[0]}")
    # one rank_answer: the question encoder's sites and two decodes
    check(counts == {**NO_LAUNCHES, "flash_attention": vit + text + 2 * fusion + 4 * dec},
          f"prompt from_checkpoint launches {counts}")
    check(got == want_rank and all(math.isfinite(p) for ans in got for _, p in ans),
          "the prompt checkpoint ranks differently from the trainer's parameters")
    shutil.rmtree(ckpt)
    del model, served, pred, direct, trainer
    torch.cuda.empty_cache()


def modes_joint(torch, seed):
    """(c) the joint DAT step on full-width ViLT-B/32 at B=64, S=185 on
    "layer": its weighted rows take the "block" way (#1, #3; no #4); its four
    gradient sets against the standard step's plain fp32 path by the 2x-bf16
    rule; launches from the device; samples/s against the standard "block"
    step -> the launches per replayed joint step measured on the device."""
    from feddat_tpu_torch.configs.core import OptimizerConfig, PEFTMode
    from feddat_tpu_torch.train import dat
    from feddat_tpu_torch.train.trainers import make_vilt_joint_dat_step

    model = build_trainer_model(torch, seed, "layer")
    layers = model.config.num_layers
    params = {k: v.detach() for k, v in model.state_dict().items()}
    batch = to_cuda_batch(torch, train_client(TRAIN_CLIENTS[0], TB, 0, seed))
    part = dat.Partitioner(params, TRAIN_CLIENTS[0], PEFTMode.DAT)
    joint = make_vilt_joint_dat_step(model, TRAIN_CLIENTS[0], part, OptimizerConfig(), 100)
    state0 = dat.init_train_state(params, part, OptimizerConfig(), torch.Generator().manual_seed(seed))
    want = {**NO_LAUNCHES, "attn_block": layers, "attn_block_bwd": layers - 1}
    with graph_mode(False):
        torch.cuda.synchronize()
        reset_counts()
        _, jm = joint(state0, batch)
        torch.cuda.synchronize()
        counts = read_counts()
    print(f"modes: joint DAT step, attn_impl='layer', B={TB} (2B={2 * TB} rows) S={TS}: launches "
          f"{counts_text(counts)} (expected {counts_text(want)}: one pass, the weighted rows the "
          f"'block' way, no #4; layer 0 without a backward)")
    check(counts == want, f"joint step launches {counts}, expected {want}")
    sd = model.state_dict()
    before = read_counts()
    plain = make_steps(build_trainer_model(torch, seed, "auto", sd), params, False)[0](state0, batch)[1]
    exact = make_steps(build_trainer_model(torch, seed, "auto", sd, "float32"), params,
                       False)[0](state0, batch)[1]
    torch.cuda.synchronize()
    check(read_counts() == before, "the plain path launched a kernel")
    grad_agreement(torch, "joint step against the standard step", jm, plain, exact)
    del jm, plain, exact
    torch.cuda.empty_cache()
    replay = graph_vs_eager(torch, f"ViLT joint DAT step (layer, B={TB}, S={TS})",
                            lambda: joint(state0, batch), want)
    block = build_trainer_model(torch, seed, "block", sd)
    del joint
    speed = alternating_speed(torch, {
        "joint": lambda: (make_vilt_joint_dat_step(model, TRAIN_CLIENTS[0], part, OptimizerConfig(), 100),
                          state0, batch),
        "standard block": lambda: (make_steps(block, params, fused=False)[0], state0, batch)}, TB)
    for name, (rate, samples, reserved, allocated) in speed.items():
        print(f"time modes: ViLT {name} DAT step (B={TB}, S={TS}): {rate:.1f} samples/s (replayed "
              f"graph, median of {len(samples)}: {samples}); own peak reserved {reserved:.2f} GiB, "
              f"allocated {allocated:.2f} GiB")
    print(f"time modes: joint / standard 'block' rate {speed['joint'][0] / speed['standard block'][0]:.3f}")
    del model, block
    torch.cuda.empty_cache()
    return replay


def modes_vilt(torch, seed):
    """(d) ViLT-B/32 in modes adapter, none and freeze_encoder: one plain
    step each on "fused" with its #5/#6 launches, the 2x-bf16 rule and the
    launches per replay measured on the device -> the adapter step's."""
    from feddat_tpu_torch.train import dat
    from feddat_tpu_torch.train.forwards import to_device

    batch = to_device(next(peft_client(TRAIN_CLIENTS[0], TB, 0, seed).train_batches(0)), "cuda")
    out = None
    for mode in VILT_MODES:
        model = peft_model(torch, mode, seed, "fused")
        layers = model.config.num_layers
        adapter_mode = "adapter" if mode == "adapter" else "none"
        check((model.config.adapter.names == ("adapter",)) == (mode == "adapter"),
              f"{mode}: unexpected adapters {model.config.adapter}")
        params = {k: v.detach() for k, v in model.state_dict().items()}
        step, part, opt = peft_step(model, mode, params, adapter_mode)
        state0 = dat.init_train_state(params, part, opt, torch.Generator().manual_seed(seed))
        with graph_mode(False):
            torch.cuda.synchronize()
            reset_counts()
            _, m = step(state0, batch)
            torch.cuda.synchronize()
            launches = read_counts()
        # the attention backward runs above the lowest trained parameter:
        # above layer 0 for the adapters (after each attention), nowhere when
        # the head alone trains
        trained = layers - 1 if mode == "adapter" else 0
        want = {**NO_LAUNCHES, "fused_attention": layers, "fused_attention_bwd": trained}
        print(f"modes: ViLT {mode} step, attn_impl='fused', B={TB} S={TS}: #5/#6 launches "
              f"{launches['fused_attention']}/{launches['fused_attention_bwd']} (expected "
              f"{layers}/{trained}), loss {float(m['loss']):.4f}")
        check(launches == want, f"ViLT {mode} step launches {launches}, expected {want}")
        replay = replay_launches(torch, f"ViLT {mode} step (fused, B={TB}, S={TS})",
                                 lambda: step(state0, batch), want)
        sd = model.state_dict()
        kernel = peft_grads(torch, model, params, part, batch, adapter_mode)
        before = read_counts()
        plain = peft_grads(torch, peft_model(torch, mode, seed, "auto", state=sd), params, part, batch,
                           adapter_mode)
        exact = peft_grads(torch, peft_model(torch, mode, seed, "auto", "float32", state=sd), params,
                           part, batch, adapter_mode)
        torch.cuda.synchronize()
        check(read_counts() == before, "the plain path launched a kernel")
        grad_agreement(torch, f"ViLT {mode}", kernel, plain, exact, ("loss",))
        if mode == "adapter":
            out = replay
        del model, params, step, state0, kernel, plain, exact, sd
        torch.cuda.empty_cache()
    return out


def modes_cli(torch, seed, root):
    """(e) an albef_distill launch, ``python -m feddat_tpu_torch.cli`` with
    scripts/train_albef.sh's flags and ``--optimizer_mode adapter --dtype
    bfloat16 --attn_impl flash`` on phase 12's dataset, 1 client x 3 steps
    (``--debug 2``), profiled, then ``from_checkpoint`` on "flash"."""
    work = Path(root) / "modes_cli"
    work.mkdir()
    ckpt, profile, out = work / "ckpt", work / "profile", work / "logs"
    vocab = str(REPO / "tests" / "fixtures" / "vocab30k.txt")
    argv = script_flags("train_albef.sh") + [
        "--encoder_name", "albef_distill", "--optimizer_mode", "adapter", "--dtype", "bfloat16",
        "--attn_impl", "flash", "--climb_data_dir", root, "--vocab_file", vocab, "--splits", *CLI_SPLITS,
        "--ordered_cl_tasks", DISK_TASKS[0], "--batch_size", str(MODES_AB), "--val_batch_size", str(MODES_AB),
        "--comm_rounds", "1", "--eval_every", "1", "--wandb_freq", "1", "--debug", "2",
        "--checkpoint_dir", str(ckpt), "--profile_dir", str(profile), "--output_dir", str(out)]
    rc, wall, t0, text = launch_cli("albef_distill, train_albef.sh's flags, adapter, flash", argv,
                                    work / "distill.log")
    check(rc == 0, "the albef_distill launch failed")
    history, records = cli_outputs(out, f"albef_distill_adapter_bs{MODES_AB}_lr0.0001_rounds1x1_seed2")
    cli_stages("albef_distill", t0, text)
    cli_timeline("albef_distill", t0, wall, records)
    steps = min(DISK_TRAIN // MODES_AB, 3)  # --debug 2: batches 0..2
    dev, graphs, _ = profile_counts(profile)
    per = {k: dev[k] / (steps + 1) for k in FLASH_KEYS}
    print(f"cli: albef_distill history {history}; round 0's profile: #7/#8/#9 {flash_launches(dev)} "
          f"device launches over {steps} steps ({graphs} graph replays) and 1 capture warm-up: {per}")
    check(history[-1]["round"] == 0 and math.isfinite(history[-1]["scores"][DISK_TASKS[0]]),
          "the albef_distill history lacks its score")
    check(dev["flash_attention"] == 24 * (steps + 1) and dev["flash_attention_bwd_dq"] == 11 * (steps + 1)
          and dev["flash_attention_bwd_dkv"] == 11 * (steps + 1) and graphs == steps,
          f"albef_distill profile launches {dev}, {graphs} replays")
    check(sum(r["kind"] == "step" for r in records) == steps, "the step records")
    cli_albef_serving(torch, root, seed, str(ckpt))
    shutil.rmtree(work)


def phase_modes(torch, seed, root):
    """Phase 14 (see the module docstring) -> the launches per replayed call
    measured on the device on this slice's paths: the distill step for #7-#9,
    the joint step for #1 and #3, the ViLT adapter step for #5 and #6."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    launches = {}

    def timed(part, fn, *args):
        t0 = time.perf_counter()
        out = fn(torch, seed, *args)
        print(f"modes: {part} took {time.perf_counter() - t0:.1f} s")
        return out

    replay = timed("distillation", modes_distill)
    launches.update({k: replay[k] for k in FLASH_KEYS})
    timed("prompts", modes_prompt, root)
    replay = timed("the joint step", modes_joint)
    launches.update({k: replay[k] for k in ("attn_block", "attn_block_bwd")})
    vilt = timed("the ViLT modes", modes_vilt)
    launches.update({k: vilt[k] for k in ("fused_attention", "fused_attention_bwd")})
    timed("the CLI launch", modes_cli, root)
    print(f"modes: phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


# Phase 15: the SPMD engine (federated/spmd.py) in a world of one over NCCL.
# One client and one data rank: the gradient mean, FedAvg and the evaluation
# gather are all-reduces over groups of one (NCCL runs them; the step's sits
# inside its captured graph), so the round must be the sequential engine's,
# bitwise: a group of one and a FedAvg weight of 1.0 change nothing.
SPMD_STEPS = 2
SPMD_CLIENT = "fed"  # the SPMD engine's shared head, task_fed


class CollectiveCalls:
    """Counts the calls of ``torch.distributed.all_reduce`` made inside the
    block, those made while a CUDA graph was being captured (a call in a
    capture is recorded into the graph; one outside runs from the host), and
    by group (``by_group[group]``, None for the world)."""

    def __enter__(self):
        import torch
        import torch.distributed as dist

        self.calls = self.captured = 0
        self.by_group = Counter()
        self._inner = inner = dist.all_reduce

        def all_reduce(*args, **kwargs):
            self.calls += 1
            self.by_group[kwargs.get("group", args[2] if len(args) > 2 else None)] += 1
            self.captured += torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()
            return inner(*args, **kwargs)

        dist.all_reduce = all_reduce
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.all_reduce = self._inner


def graph_collectives(torch, label, call, nccl_kernels, stats=None):
    """One profiled call of a step whose graph exists: one graph launch and
    no all-reduce called from the host.  With ``nccl_kernels`` (a group of
    more than one rank) the step's all-reduce must also show as NCCL kernels
    launched by the replay (by the kineto correlation of each device kernel
    with the host's ``cudaGraphLaunch``) and none outside it; NCCL's in-place
    all-reduce over a group of one launches nothing.  -> the replay's device
    ms and its NCCL kernels' share of them; ``stats["nccl_in_replay"]``, when
    a dict is given, the number of NCCL kernels the replay launched."""
    from torch.profiler import ProfilerActivity, profile

    call()  # a capture, where the step has none yet, stays out of the profile
    torch.cuda.synchronize()
    with CollectiveCalls() as calls, profile(activities=[ProfilerActivity.CPU,
                                                         ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    graph_ids = {k.correlation_id() for k in events
                 if k.device_type() != cuda and k.name() == "cudaGraphLaunch"}
    inside, outside, busy, nccl_us = Counter(), Counter(), 0.0, 0.0
    for k in events:
        if k.device_type() != cuda:
            continue
        us = (k.end_ns() - k.start_ns()) / 1e3
        busy += us
        if "nccl" in k.name().lower():
            nccl_us += us
            (inside if k.correlation_id() in graph_ids else outside)[k.name()] += 1
    print(f"spmd: {label}: one profiled step: {len(graph_ids)} graph launch(es), {calls.calls} "
          f"all-reduce calls from the host; device busy {busy / 1e3:.3f} ms, NCCL kernels "
          f"{nccl_us / 1e3:.3f} ms of it, inside the replay {dict(inside)}, outside it {dict(outside)}")
    check(len(graph_ids) == 1 and calls.calls == 0,
          f"{label}: a replayed step made {len(graph_ids)} graph launches and {calls.calls} "
          "all-reduce calls from the host")
    if nccl_kernels:
        check(sum(inside.values()) >= 1 and not outside,
              f"{label}: the step's all-reduce is not a node of its replayed graph")
    if stats is not None:
        stats["nccl_in_replay"] = sum(inside.values())
    return busy / 1e3, nccl_us / 1e3


def spmd_against_sequential(torch, label, make_model, client, tcfg, seq_kw, spmd_kw, path_keys):
    """One round and its evaluation of the SPMD engine and of the sequential
    engine on the same model, client, weights, seed and steps (the engines
    call the model functionally and never write the weights): server
    parameters, personal store and scores bitwise equal, the same launches
    of every kernel -> the SPMD run's launches."""
    from feddat_tpu_torch.federated.engine import FederatedTrainer
    from feddat_tpu_torch.federated.spmd import SPMDFederatedTrainer
    from feddat_tpu_torch.parallel.mesh import make_mesh
    from feddat_tpu_torch.train import compiled

    from feddat_tpu_torch.train.dat import init_train_state
    from feddat_tpu_torch.train.forwards import to_device

    runs = {}
    model, params = make_model()
    for engine in ("sequential", "spmd"):
        if engine == "spmd":
            trainer = SPMDFederatedTrainer(model, params, [client()], tcfg, make_mesh(1), **spmd_kw)
        else:
            trainer = FederatedTrainer(model, params, {SPMD_CLIENT: client()}, tcfg, **seq_kw)
        torch.cuda.synchronize()
        cap0, rep0 = compiled.STATS["captures"], compiled.STATS["replays"]
        reset_counts()  # the main path: one round and its evaluation
        t0 = time.perf_counter()
        with CollectiveCalls() as calls:
            trainer.run_round(0)
            entry = trainer.evaluate_round(0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        captures, replays = compiled.STATS["captures"] - cap0, compiled.STATS["replays"] - rep0
        personal = trainer.personal() if engine == "spmd" else trainer.personal[SPMD_CLIENT]
        runs[engine] = dict(counts=counts, scores=entry["scores"], server=trainer.server_params,
                            personal=personal)
        print(f"spmd: {label}, {engine} engine: round of {SPMD_STEPS} steps and evaluate_dat in "
              f"{wall:.2f} s ({captures} captures, {replays} replays; {calls.calls} all-reduce calls, "
              f"{calls.captured} of them inside a capture), launches {counts_text(counts)}; scores "
              f"{entry['scores']}")
        if engine == "spmd":
            # the SPMD step was captured with its all-reduce and replayed
            check(captures >= 1 and replays >= 1 and calls.captured >= 1,
                  f"{label}: the SPMD round made {captures} captures, {replays} replays and "
                  f"{calls.captured} all-reduce calls inside a capture")
            state = init_train_state({**trainer.backbone, **trainer.client_state}, trainer.partitioner,
                                     tcfg.optimizer, torch.Generator().manual_seed(1))
            batch = to_device(next(client().train_batches(0)), trainer.device)
            graph_collectives(torch, label, lambda: trainer.train_step(state, batch), nccl_kernels=False)
            del state, batch
        del trainer
    del model, params
    seq, spmd = runs["sequential"], runs["spmd"]
    pairs = [(f"server/{k}", v, spmd["server"][k]) for k, v in seq["server"].items()]
    pairs += [(f"personal/{k}", v, spmd["personal"][k]) for k, v in seq["personal"].items()]
    bad = [k for k, a, b in pairs if not torch.equal(a, b)]
    print(f"spmd: {label}: {len(bad)} of {len(pairs)} tensors differ from the sequential engine's "
          f"(bitwise rule; {len(seq['server'])} server, {len(seq['personal'])} personal); scores "
          f"equal: {spmd['scores'] == seq['scores']}; launches equal: {spmd['counts'] == seq['counts']}")
    check(set(seq["server"]) == set(spmd["server"]) and set(seq["personal"]) == set(spmd["personal"]),
          f"{label}: the engines' parameter names differ")
    check(not bad, f"{label}: the SPMD round differs from the sequential one: {bad[:4]}")
    check(spmd["scores"] == seq["scores"], f"{label}: scores {spmd['scores']} != {seq['scores']}")
    check(spmd["counts"] == seq["counts"], f"{label}: launches {spmd['counts']} != {seq['counts']}")
    check(all(spmd["counts"][k] > 0 for k in path_keys), f"{label}: a kernel of the path never "
          f"launched: {counts_text(spmd['counts'])}")
    runs["sequential"] = runs["spmd"] = None
    torch.cuda.empty_cache()
    return spmd["counts"]


def phase_spmd(torch, seed):
    """Phase 15 (see the module docstring) -> the launches of the SPMD runs
    of the kernels on their paths: #1 and #4 (ViLT), #7-#9 (ALBEF)."""
    from feddat_tpu_torch.configs.core import FederatedConfig, OptimizerConfig, PEFTMode, TrainConfig
    from feddat_tpu_torch.data.synthetic import SyntheticAlbefClient
    from feddat_tpu_torch.models import create_model
    from feddat_tpu_torch.models.vilt import TaskHeadSpec
    from feddat_tpu_torch.parallel.mesh import world
    from feddat_tpu_torch.train.trainers import resolve_trainer

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    launches = {}
    with world(torch.device("cuda", 0)) as size:
        import torch.distributed as dist

        print(f"spmd: a world of {size} over {dist.get_backend()}")
        check(size == 1 and dist.get_backend() == "nccl", "the world of one is not NCCL's")

        # (a) ViLT-B/32 DAT, the fused step on "layer", bf16, B=64, S=185
        def vilt():
            model, cfg = create_model("vilt", {SPMD_CLIENT: TaskHeadSpec(num_labels=NUM_LABELS)},
                                      PEFTMode.DAT, 16, "bfloat16", image_size=TCANVAS,
                                      attn_impl="layer", seed=seed)
            return model, {k: v.detach() for k, v in model.state_dict().items()}

        vcfg = TrainConfig(peft_mode=PEFTMode.DAT, optimizer=OptimizerConfig(),
                           federated=FederatedConfig(comm_rounds=1, local_epochs=1, eval_every=1),
                           num_epochs=1, seed=seed)
        counts = spmd_against_sequential(
            torch, f"ViLT-B/32 DAT, fused step, 'layer', B={TB}, S={TS}", vilt,
            lambda: train_client(SPMD_CLIENT, SPMD_STEPS * TB, TB, seed + 1), vcfg,
            dict(use_fused_dat=True), dict(use_fused=True),
            ("attn_block", "layer_block_bwd"))
        launches.update({k: counts[k] for k in ("attn_block", "layer_block_bwd")})

        # (b) ALBEF no-distill DAT on "flash", dropout live, B=48 x 4, and
        # its rank-answer evaluation
        def albef_client():
            return SyntheticAlbefClient(SPMD_CLIENT, num_train=SPMD_STEPS * ATB, num_eval=ATB,
                                        num_answers=len(ALBEF_ANSWERS), vocab_size=30522,
                                        question_len=LQ, answer_len=LA, max_answers_per_q=ANS_PER_Q,
                                        image_size=(ARES, ARES), batch_size=ATB, val_batch_size=ATB,
                                        seed=seed + 2)

        bank = albef_client()
        banks = {SPMD_CLIENT: (bank.answer_ids, bank.answer_mask)}
        hooks = resolve_trainer("albef_no_distill", "vqa", rank_k=ALBEF_K, answer_banks=banks)
        acfg = TrainConfig(encoder_name="albef_no_distill", peft_mode=PEFTMode.DAT,
                           optimizer=OptimizerConfig(),
                           federated=FederatedConfig(comm_rounds=1, local_epochs=1, eval_every=1),
                           num_epochs=1, seed=seed)

        def albef():
            model = albef_train_model(torch, seed, "flash")
            return model, {k: v.detach() for k, v in model.state_dict().items()}

        counts = spmd_against_sequential(
            torch, f"ALBEF DAT, fused step, 'flash', dropout live, B={ATB} x {ANS_PER_Q}", albef,
            albef_client, acfg,
            dict(make_forward=hooks.make_forward, make_eval=hooks.make_eval, use_fused_dat=True),
            dict(use_fused=True, family="albef", answer_banks=banks, rank_k=ALBEF_K), FLASH_KEYS)
        launches.update({k: counts[k] for k in FLASH_KEYS})
    check(not dist.is_initialized(), "the world of one outlived its block")
    print(f"spmd: launches of the SPMD rounds {counts_text(launches)}")
    print(f"spmd: phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


# Phase 16: the ViLT family's other tasks (ROADMAP item 10).  The CLI's own
# builders (flags of scripts/train_vilt_tpu_tuned.sh on the sequential
# engine) on phase 16's dataset: NLVR2 (two images per example, the second
# with modality type 2), SNLI-VE and VCR (four choices) on full-width
# ViLT-B/32 DAT, bf16, "layer", canvas 384x640 (S=281), the standard DAT step
# (JAX sends classification tasks there); then ViLT-BERT on the low-shot
# VQAv2 client.  VCR's gradient check runs on the first 16 examples of its
# batch: the fp32 plain path of 64 x 4 choices needs ~60 GiB.
CLS_GRAD_ROWS = {"vcr": 16}


def classify_args(root, encoder, tasks):
    from feddat_tpu_torch import cli

    vocab = str(REPO / "tests" / "fixtures" / "vocab30k.txt")
    return cli.build_parser().parse_args(script_flags("train_vilt_tpu_tuned.sh") + [
        "--encoder_name", encoder, "--ordered_cl_tasks", tasks, "--climb_data_dir", root,
        "--vocab_file", vocab, "--comm_rounds", "1", "--eval_every", "1"])


def classify_trainer(torch, args):
    """-> (task keys, clients, model, params, trainer), as a launch builds them."""
    from feddat_tpu_torch import cli
    from feddat_tpu_torch.configs.core import PEFTMode
    from feddat_tpu_torch.configs.tasks import TASK_CONFIGS
    from feddat_tpu_torch.models.vilt import TaskHeadSpec

    keys = cli.resolve_task_keys(args.ordered_cl_tasks)
    heads = {k: TaskHeadSpec(num_labels=TASK_CONFIGS[k].num_labels,
                             num_images=TASK_CONFIGS[k].num_images,
                             model_type=TASK_CONFIGS[k].model_type,
                             num_choices=TASK_CONFIGS[k].num_choices) for k in keys}
    device = torch.device("cuda")
    model, cfg, _ = cli.build_model(args, PEFTMode(args.optimizer_mode), heads, device)
    clients, banks = cli.build_clients(args, keys, disk_tokenizer())
    params = cli.init_params(args, model, cfg)
    trainer = cli.sequential_trainer(args, keys, model, params, clients, banks,
                                     cli.train_config(args, keys), device)
    return keys, clients, model, params, trainer


def passes_per_example(spec):
    return spec.num_choices if spec.model_type == "multi-choice" else spec.num_images


def classify_grads(torch, seed, model, params, runtime):
    """One standard DAT step of a task's shape: its gradient sets and losses,
    kernel path ("layer") against the plain path in bf16 and in fp32."""
    from feddat_tpu_torch.models import create_model
    from feddat_tpu_torch.train import dat
    from feddat_tpu_torch.train.forwards import make_vilt_forward, to_device

    key = runtime.task_key
    batch = next(runtime.data.train_batches(0))
    rows = CLS_GRAD_ROWS.get(key, len(batch["labels"]))
    batch = to_device({k: v[:rows] for k, v in batch.items()}, "cuda")
    sd = model.state_dict()

    def grads(m):
        step = dat.make_dat_train_step(make_vilt_forward(m, key, loss="ce"), runtime.partitioner,
                                       runtime.opt_cfg, 100)
        state = dat.init_train_state(params, runtime.partitioner, runtime.opt_cfg,
                                     torch.Generator().manual_seed(seed))
        return step(state, batch)[1]

    def plain(dtype, logits):
        m = create_model("vilt", model.task_heads, runtime.partitioner.mode, 16, dtype,
                         image_size=CANVAS, attn_impl="auto", attention_logits_dtype=logits,
                         seed=None)[0]
        m.load_state_dict(sd)
        return m

    kernel = grads(model)
    torch.cuda.synchronize()
    before = read_counts()
    ref = grads(plain("bfloat16", "bfloat16"))
    exact = grads(plain("float32", "float32"))
    torch.cuda.synchronize()
    check(read_counts() == before, "the plain path launched a kernel")
    spec = model.task_heads[key]
    return grad_agreement(torch, f"classify {key} ({rows} x {passes_per_example(spec)} passes, "
                                 f"S={S})", kernel, ref, exact)


def classify_round(torch, seed, root):
    """(a) the three tasks: each shape's gradients by the 2x-bf16 rule, then
    one sequential round (2 standard DAT steps per client, FedAvg,
    evaluate_dat) with each client's launches per step and peak memory ->
    the round's launches of #1 and #4."""
    from feddat_tpu_torch.train import compiled

    args = classify_args(root, "vilt", ",".join(CLS_TASKS))
    keys, clients, model, params, trainer = classify_trainer(torch, args)
    layers = model.config.num_layers
    for c in trainer.clients:
        spec = model.task_heads[c.task_key]
        print(f"classify: {c.task_key}: {c.data.num_train_examples} train / "
              f"{c.data.num_eval_examples} eval examples, batch {c.data.batch_size} x "
              f"{passes_per_example(spec)} passes, {c.data.steps_per_epoch} steps; lr {c.opt_cfg.lr}, "
              f"program {c.train_step.program.name}")
        check(c.data.steps_per_epoch == 2, f"{c.task_key}: {c.data.steps_per_epoch} steps per epoch")
        check(c.train_step.program.name == "dat_step", f"{c.task_key} does not take the "
              f"standard DAT step: {c.train_step.program.name}")
    with compiled.disable_graphs():
        ratios = {c.task_key: classify_grads(torch, seed, model, params, c) for c in trainer.clients}
    torch.cuda.empty_cache()

    per_client, inner = {}, trainer.train_client

    def measured(client, round_idx):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before, t0 = read_counts(), time.perf_counter()
        out = inner(client, round_idx)
        torch.cuda.synchronize()
        after = read_counts()
        per_client[client.task_key] = (
            {k: after[k] - before[k] for k in after}, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 2 ** 30, torch.cuda.max_memory_reserved() / 2 ** 30)
        return out

    trainer.train_client = measured
    reset_counts()
    trainer.run_round(0)
    entry = trainer.evaluate_round(0)
    torch.cuda.synchronize()
    launches = read_counts()
    want_round = {**NO_LAUNCHES, "attn_block": 0, "layer_block_bwd": 0}
    for c in trainer.clients:
        p = passes_per_example(model.task_heads[c.task_key])
        counts, secs, peak, reserved = per_client[c.task_key]
        steps = c.data.steps_per_epoch
        want = {**NO_LAUNCHES, "attn_block": 3 * p * layers * steps,
                "layer_block_bwd": 2 * p * layers * steps}
        print(f"classify: {c.task_key} ({p} encoder passes per example): {steps} standard DAT steps "
              f"in {secs:.2f} s (captures included); per step #1 {counts['attn_block'] / steps:.0f}, "
              f"#4 {counts['layer_block_bwd'] / steps:.0f}, #3 {counts['attn_block_bwd'] / steps:.0f} "
              f"(want {3 * p * layers}/{2 * p * layers}/0); peak {peak:.2f} GiB allocated, "
              f"{reserved:.2f} GiB reserved")
        check(counts == want, f"{c.task_key}: launches {counts}, expected {want}")
        evals = -(-c.data.num_eval_examples // c.data.val_batch_size)
        want_round["attn_block"] += want["attn_block"] + 3 * p * layers * evals
        want_round["layer_block_bwd"] += want["layer_block_bwd"]
    print(f"classify: round of {len(keys)} clients and evaluate_dat: launches {counts_text(launches)}; "
          f"scores {entry['scores']}; gradient error over tol, worst per task {ratios}")
    check(launches == want_round, f"round launches {launches}, expected {want_round}")
    for key, scores in entry["scores"].items():
        check(len(scores) == 3 and all(math.isfinite(v) and 0.0 <= v <= 100.0 for v in scores),
              f"bad evaluate_dat scores for {key}: {scores}")
    moved = [k for k, v in trainer.server_params.items()
             if "adapter_1" in k and not torch.equal(v, params[k])]
    check(len(moved) == 4 * layers, "FedAvg did not update every adapter_1 tensor on the server")
    return {k: launches[k] for k in ("attn_block", "layer_block_bwd")}


def classify_viltbert(torch, seed, root):
    """(b) ViLT-BERT on the low-shot VQAv2 client: one round of 2 fused steps
    (whose text BERT runs deterministic, as JAX's: the fused step reads the
    ViLT config's dropout, 0) and evaluate_dat, then 2 standard DAT steps with
    the BERT's dropout 0.1 live; text_bert bitwise unchanged by both."""
    from feddat_tpu_torch.train import dat
    from feddat_tpu_torch.train.forwards import make_vilt_forward, to_device

    args = classify_args(root, "viltbert", "vqa")
    keys, clients, model, params, trainer = classify_trainer(torch, args)
    layers = model.config.num_layers
    text = {k: v.clone() for k, v in params.items() if k.startswith("text_bert.")}
    (c,) = trainer.clients
    steps = c.data.steps_per_epoch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    trainer.run_round(0)
    torch.cuda.synchronize()
    counts = read_counts()
    entry = trainer.evaluate_round(0)
    print(f"classify: ViLT-BERT vqa (5% low-shot, {c.data.num_train_examples} train, B="
          f"{c.data.batch_size}, u8 pixels normalised on the card), {steps} fused steps "
          f"({c.train_step.program.name}): launches {counts_text(counts)} ({counts['attn_block'] / steps:.0f}"
          f"/{counts['layer_block_bwd'] / steps:.0f} per step); peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; evaluate_dat {entry['scores']}")
    check(c.train_step.program.name == "dat_step_fused", "ViLT-BERT on VQA: not the fused step")
    check(counts == {**NO_LAUNCHES, "attn_block": 2 * layers * steps,
                     "layer_block_bwd": 2 * layers * steps}, f"ViLT-BERT fused launches {counts}")
    check(all(torch.equal(trainer.server_params[k], v) for k, v in text.items()),
          "the fused round moved text_bert")

    step = dat.make_dat_train_step(make_vilt_forward(model, "vqa"), c.partitioner, c.opt_cfg, 100)
    batch = to_device(next(clients["vqa"].train_batches(0)), "cuda")

    def two_steps(s):
        state = dat.init_train_state(params, c.partitioner, c.opt_cfg, torch.Generator().manual_seed(s))
        losses = []
        for _ in range(2):
            state, m = step(state, batch)
            losses.append((float(m["loss"]), float(m["loss_shared"])))
        return state, losses

    reset_counts()
    state, losses = two_steps(seed)
    torch.cuda.synchronize()
    counts = read_counts()
    _, again = two_steps(seed)
    _, other = two_steps(seed + 1)
    print(f"classify: ViLT-BERT standard DAT steps, text BERT dropout 0.1 live: launches "
          f"{counts_text(counts)}; losses {losses}, same seed {again}, seed + 1 {other}")
    check(counts == {**NO_LAUNCHES, "attn_block": 2 * 3 * layers, "layer_block_bwd": 2 * 2 * layers},
          f"ViLT-BERT standard step launches {counts}")
    check(again == losses and other != losses, "the text BERT's dropout is not live and seeded")
    check(all(torch.equal(state.params[k], v) for k, v in text.items()),
          "a standard step moved text_bert")


def phase_classify(torch, seed, root):
    """Phase 16 (see the module docstring) -> the round's launches of #1 and #4."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    data = str(Path(root) / "classify")
    write_classification_dataset(data, seed)
    t0 = time.perf_counter()
    launches = classify_round(torch, seed, data)
    print(f"classify: the three tasks took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    classify_viltbert(torch, seed, data)
    print(f"classify: ViLT-BERT took {time.perf_counter() - t0:.1f} s")
    shutil.rmtree(data)
    print(f"classify: phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


STUDY_CLIENTS, STUDY_ROUNDS = 4, 2
STUDY_CHANCE = 100.0 / 11  # the 8 shared and 3 personal answers a client can give


def phase_study(torch, seed):
    """Phase 17 (see the module docstring) -> the run's launches of #1 and #3."""
    from feddat_tpu_torch import study
    from feddat_tpu_torch.train import compiled

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    rounds, losses = [], []

    class Steps:  # the engine's metrics logger: each step's losses, left on the card
        def step(self, metrics, batch_size, task_key):
            losses.append(torch.stack([metrics["loss"], metrics["loss_shared"]]))

        def round(self, round_idx, scores, wall_s):
            pass

    class Probe(study.FederatedTrainer):
        """The study's engine with each round's steps, launches, captures and
        replays read around it."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, metrics_logger=Steps(), **kwargs)

        def run_round(self, round_idx):
            torch.cuda.synchronize()
            before, n0 = read_counts(), len(losses)
            cap0, rep0 = compiled.STATS["captures"], compiled.STATS["replays"]
            super().run_round(round_idx)
            torch.cuda.synchronize()
            counts = {k: v - before[k] for k, v in read_counts().items()}
            rounds.append(dict(steps=len(losses) - n0, counts=counts, wall=self._last_round_wall_s,
                               captures=compiled.STATS["captures"] - cap0,
                               replays=compiled.STATS["replays"] - rep0))

    engine, study.FederatedTrainer = study.FederatedTrainer, Probe
    try:
        reset_counts()
        t0 = time.perf_counter()
        results = study.run_study(modes=("dat",), seeds=(seed,), num_clients=STUDY_CLIENTS,
                                  comm_rounds=STUDY_ROUNDS, family="vilt")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = read_counts()
    finally:
        study.FederatedTrainer = engine
    (history,) = results["dat"]["histories"]
    table = results["dat"]["table"]
    layers = 12
    client = study.HeterogeneousVQAClient
    steps_per_round = client.num_train // client.batch_size
    # the standard DAT step on "block" with block_save_nox remat: #1 three
    # times per layer (its outputs kept), #3 for layers 1..L-1 twice
    want = {**NO_LAUNCHES, "attn_block": 3 * layers, "attn_block_bwd": 2 * (layers - 1)}
    for i, r in enumerate(rounds):
        per_step = {k: v / r["steps"] for k, v in r["counts"].items() if v}
        print(f"study: round {i}: {r['steps']} steps of {STUDY_CLIENTS} clients, engine round wall "
              f"{r['wall']:.3f} s, {r['captures']} captures, {r['replays']} replays; launches per "
              f"step {per_step} (expected {counts_text(want)})")
        check(r["steps"] == STUDY_CLIENTS * steps_per_round
              and r["counts"] == {k: r["steps"] * v for k, v in want.items()},
              f"study round {i}: {r['steps']} steps, launches {r['counts']}")
        check(r["replays"] >= r["steps"] and (i == 0 or r["captures"] == 0),
              f"study round {i}: {r['captures']} captures and {r['replays']} replays for "
              f"{r['steps']} steps")
    check(len(rounds) == STUDY_ROUNDS, f"study: {len(rounds)} rounds")
    got = torch.stack(losses).float().cpu()
    print(f"study: {len(losses)} steps' losses (adapter_0, adapter_1): first {got[0].tolist()}, "
          f"last {got[-1].tolist()}")
    check(bool(torch.isfinite(got).all()), "study: a logged loss is not finite")
    check(len(history) == 1 and history[0]["round"] == STUDY_ROUNDS - 1
          and set(history[0]["scores"]) == {f"client_{i}" for i in range(STUDY_CLIENTS)}
          and all(len(s) == 3 for s in history[0]["scores"].values())
          and set(table) == {f"client_{i}" for i in range(STUDY_CLIENTS)} | {"average"},
          f"study: history {history}, table keys {sorted(table)}")
    for key, (ens, local, shared) in history[0]["scores"].items():
        print(f"study: {key}: ensemble {ens:.3f}, local (adapter_0) {local:.3f}, shared "
              f"(adapter_1) {shared:.3f}")
    avg = table["average"]["mean"]
    print(f"study: average ensemble score {avg:.3f} (chance {STUDY_CHANCE:.3f}); run_study took "
          f"{run_s:.1f} s, launches in all {counts_text(launches)}")
    check(avg > STUDY_CHANCE, f"study: average ensemble score {avg} is not above chance")
    print(f"study: phase took {time.perf_counter() - t_phase:.1f} s")
    return {k: launches[k] for k in ("attn_block", "attn_block_bwd")}


# Phase 18: tensor parallelism (ROADMAP item 12b).  Two ranks in processes of
# their own share the one card over gloo at (data=1, model=2); the world-of-one
# engine runs here meanwhile, in bf16 and in fp32.
TP_STEPS = 2
TP_CLIENT = "tp"
# a 16-label head: a random-init 3129-label head scores 0 on every example
# after two steps, which would leave the scores' check nothing to compare
TP_LABELS = 16


def tp_round(torch, seed, dtype, mesh=None):
    """One round of TP_STEPS fused DAT steps and evaluate_dat of full-width
    ViLT-B/32 on "auto", eagerly, on ``mesh`` (None: the world of one) ->
    the communicated partition's update, the scores, the launches, the
    backbone's bytes on this rank and the round's wall."""
    from feddat_tpu_torch.configs.core import FederatedConfig, OptimizerConfig, PEFTMode, TrainConfig
    from feddat_tpu_torch.data.synthetic import SyntheticVQAClient
    from feddat_tpu_torch.federated.engine import FederatedTrainer
    from feddat_tpu_torch.models import create_model
    from feddat_tpu_torch.models.vilt import TaskHeadSpec
    from feddat_tpu_torch.parallel import tp
    from feddat_tpu_torch.train import compiled

    model, _ = create_model("vilt", {TP_CLIENT: TaskHeadSpec(num_labels=TP_LABELS)}, PEFTMode.DAT,
                            16, dtype, image_size=TCANVAS, attn_impl="auto", seed=seed)
    cfg = TrainConfig(peft_mode=PEFTMode.DAT, optimizer=OptimizerConfig(lr=1e-3, warmup_ratio=0.0),
                      federated=FederatedConfig(comm_rounds=1, local_epochs=1, eval_every=1),
                      num_epochs=1, seed=seed)
    client = SyntheticVQAClient(TP_CLIENT, num_train=TP_STEPS * TB, num_eval=TB, num_labels=TP_LABELS,
                                vocab_size=30522, text_len=TEXT_LEN, image_size=TCANVAS,
                                batch_size=TB, val_batch_size=TB, seed=seed + 5)
    trainer = FederatedTrainer(model, None, {TP_CLIENT: client}, cfg, use_fused_dat=True,
                               tp_mesh=mesh, device="cuda")
    init = {k: v.clone() for k, v in trainer.server_params.items() if "adapter_1" in k}
    with compiled.disable_graphs():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        trainer.run_round(0)
        entry = trainer.evaluate_round(0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    update = {k: (trainer.server_params[k] - v).float().cpu() for k, v in init.items()}
    return {"update": update, "scores": entry["scores"][TP_CLIENT], "counts": counts,
            "bytes": tp.backbone_bytes(trainer.server_params), "wall": wall,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def _tp_rank(rank, store, out, seed):
    """A rank of phase 18 (a process of its own): gloo from a file store, the
    card shared, the (data=1, model=2) mesh."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(REPO))
    from feddat_tpu_torch.parallel.tp import make_tp_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2)
    try:
        # the mesh's groups are gloo's (the default backend); they carry CUDA tensors
        mesh = make_tp_mesh(2, 1, device_type="cpu")
        torch.save(tp_round(torch, seed, "bfloat16", mesh), Path(out) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def phase_tp(torch, seed):
    """Phase 18 (see the module docstring)."""
    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_tp_"))
    atexit.register(shutil.rmtree, work, True)
    ranks = mp.start_processes(_tp_rank, args=(str(work / "store"), str(work), seed), nprocs=2,
                               join=False, start_method="spawn")
    # the world of one meanwhile, in bf16 and in fp32 (the exact function)
    ref = tp_round(torch, seed, "bfloat16")
    exact = tp_round(torch, seed, "float32")
    while not ranks.join():
        pass
    got = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(2)]
    label = f"ViLT-B/32 DAT, fused step, 'auto', bf16, B={TB}, S={TS}, {TP_STEPS} steps"
    for name, run in (("tp=1 bf16", ref), ("tp=1 fp32", exact), ("tp=2 rank 0", got[0]),
                      ("tp=2 rank 1", got[1])):
        b = run["bytes"]
        print(f"tp: {label}, {name}: round and evaluate_dat in {run['wall']:.2f} s, scores "
              f"{run['scores']}, sharded kernels {b['sharded'] / 2 ** 20:.2f} MiB of "
              f"{b['total'] / 2 ** 20:.2f} MiB of parameters on this rank, peak allocated "
              f"{run['peak_gib']:.2f} GiB, launches {counts_text(run['counts'])}")
    for r, run in enumerate(got):
        check(run["counts"] == NO_LAUNCHES, f"tp: rank {r} launched a kernel: {run['counts']}")
        check(2 * run["bytes"]["sharded"] == ref["bytes"]["sharded"],
              f"tp: rank {r} holds {run['bytes']['sharded']} bytes of sharded kernels, not half of "
              f"{ref['bytes']['sharded']}")
        k, kw, kn = set_error(torch, run["update"], exact["update"])
        p, pw, _ = set_error(torch, ref["update"], exact["update"])
        tol = max(TRAIN_GRAD_FACTOR * p, TRAIN_GRAD_FLOOR)
        print(f"tp: rank {r} adapter_1 update vs tp=1 fp32: {k:.3e} (worst tensor {kw:.3e} {kn}), "
              f"tp=1 bf16 {p:.3e} (worst tensor {pw:.3e}); tol {tol:.3e}")
        check(k <= tol, f"tp: rank {r}'s communicated partition disagrees: {k} > {tol}")
        floor = 100.0 / TB  # one example's score
        for i, (a, e, b) in enumerate(zip(run["scores"], exact["scores"], ref["scores"])):
            check(abs(a - e) <= max(TRAIN_GRAD_FACTOR * abs(b - e), floor),
                  f"tp: rank {r} score {i} {a} against fp32 {e} (bf16 tp=1 {b})")
    check(all(torch.equal(got[0]["update"][k], got[1]["update"][k]) for k in got[0]["update"])
          and got[0]["scores"] == got[1]["scores"], "tp: the model ranks disagree")
    print(f"tp: phase took {time.perf_counter() - t_phase:.1f} s")


# --------------------------------------------------------- phase 19: fp32
# Kernel alone in fp32: its error against the float64 function may be at most
# 8x the plain fp32 version's (cuBLAS fp32 with TF32 off, the sums in another
# order) or 2^-20 of the output's largest magnitude, whichever is larger; a
# single TF32 or bf16 product reads ~1e-3 relative, far past it.
FP32_FACTOR, FP32_FLOOR = 8.0, 2.0 ** -20
# The fp32 path against the plain fp32 path: fp32 summation order gives ~1e-6
# to 1e-5 relative, a TF32 product ~1e-3.
FP32_GRAD_TOL, FP32_LOSS_TOL = 1e-4, 1e-5
# #4's bottlenecks past the first design's multiples of 16 up to 64: a DAT
# ensemble's reduction 32 (24), 8 (96) and 4 (192).
WIDE_BOTTLENECKS = (24, 96, 192)


def float64_mode(torch):
    """A torch function mode in which every fp32 cast and fp32 dtype argument
    means float64: a plain version called on float64 inputs inside it is the
    same function evaluated in float64 (its fp32 casts taken to float64)."""
    from torch.overrides import TorchFunctionMode

    def sub(v):
        return torch.float64 if v is torch.float32 else v

    class Float64(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.Tensor.float:
                return args[0].double()
            return func(*(sub(a) for a in args), **{k: sub(v) for k, v in (kwargs or {}).items()})

    return Float64()


def to_float64(torch, args):
    return tuple(a.double() if torch.is_tensor(a) and a.is_floating_point() else a for a in args)


def bf16_operands(torch, args, which):
    """``args`` with the tensors at ``which`` (a kernel's product operands)
    rounded to bf16 once: the planted fault of the fp32 checks."""
    return tuple(a.bfloat16().float() if i in which else a for i, a in enumerate(args))


def fp32_check(torch, label, names, got, plain, exact, planted):
    """The float64 criterion on every output -> the kernel's largest error
    against the plain fp32 version (the JSON line's max_abs_err)."""
    worst = 0.0
    for name, k, p, e, f in zip(names, got, plain, exact, planted):
        e = e.double()
        check(bool(torch.isfinite(k).all()), f"fp32 {label} {name} has non-finite values")
        top = e.abs().max().item()
        k_err, p_err, f_err = ((t.double() - e).abs().max().item() for t in (k, p, f))
        lim = max(FP32_FACTOR * p_err, FP32_FLOOR * top)
        print(f"fp32 {label} {name}: max abs error against float64: kernel {k_err:.3e}, plain fp32 "
              f"{p_err:.3e} (max |ref| {top:.3e}); limit {lim:.3e} (8x plain, or 2^-20 of max |ref| "
              f"{FP32_FLOOR * top:.3e}); planted fault (operands rounded to bf16 once) {f_err:.3e}")
        check(k_err <= lim, f"fp32 {label} {name}: {k_err} against float64 > {lim}")
        check(f_err > lim, f"fp32 {label} {name}: the check passes bf16 operands ({f_err} <= {lim})")
        worst = max(worst, (k.double() - p.double()).abs().max().item())
    return worst


def layer_bwd_gated(torch, args, cfg, gate):
    """The plain #4 (single adapter) with adapter a's ReLU gate given: the
    stages of ``layer_block_bwd_reference`` with ``gate`` in place of
    down > 0."""
    from feddat_tpu_torch.ops import layer_block as lb

    (x, aout, ctx, lse, g, bias, wq, wk, wv, wo, bqkv, gb1, gb2, w1, b1, w2, b2,
     wda, bda, wua, bua, wdb, bdb, wub, bub) = args
    heads, scale, eps1, eps2, w_a, _, _ = cfg
    _, xhat2, rstd2, p1, o = lb.ffn_recompute_reference(x, aout, gb2, w1, b1, w2, b2, eps2)
    relu, g_delta, g_down = lb.adapter_bwd_reference(o, g, wda, bda, wua, w_a, gate)
    g_o = g.to(torch.float32) + g_down.to(x.dtype).to(torch.float32) @ wda.to(torch.float32).t()
    dx = lb.layer_tail_bwd_reference(g_o, xhat2, rstd2, p1, x, ctx, lse, bias, wq, wk, wv, wo, bqkv,
                                     gb1, gb2, w1, w2, heads, scale, eps1)
    return (dx, *lb.adapter_wgrads_reference(o, relu, g_delta, g_down))


def fp32_kernels(torch, seed, tb=None, ts=None, n=None, r=R, d=None):
    """(a): #1, #3, #4 and #2 alone in fp32 by the float64 criterion ->
    {kernel: max abs error against the plain fp32 version}: #1/#3/#4 at
    B=``tb``, S=``ts`` (the training shape) with adapters of bottleneck
    ``r``, #2 at ``n`` rows (the serving batch) of width ``d`` (DM)."""
    from feddat_tpu_torch.ops import adapter_fused as af
    from feddat_tpu_torch.ops import attn_block as ab
    from feddat_tpu_torch.ops import layer_block as lb

    TB, TS, n, d = tb or globals()["TB"], ts or globals()["TS"], n or B * S, d or DM  # noqa: N806
    f32, errs, f64 = torch.float32, {}, float64_mode(torch)
    with torch.no_grad():
        args = attn_inputs(torch, TB, TS, True, seed, dtype=f32)
        got, plain = ab.attn_block_cuda(*args), ab.attn_block_reference(*args)
        planted = ab.attn_block_cuda(*bf16_operands(torch, args, range(5)))
        with f64:
            exact = ab.attn_block_reference(*to_float64(torch, args))
        errs["attn_block"] = fp32_check(torch, f"attn_block B={TB} S={TS}", ("out", "ctx", "lse"), got,
                                        plain, exact, planted)
        del got, plain, planted, exact

        args = attn_bwd_case(torch, TB, TS, True, seed, dtype=f32)
        got, plain = ab.attn_block_bwd_cuda(*args), ab.attn_block_bwd_reference(*args)
        planted = ab.attn_block_bwd_cuda(*bf16_operands(torch, args, (0, 1, 2, 3, 4, 8, 10)))
        with f64:
            exact = ab.attn_block_bwd_reference(*to_float64(torch, args))
        errs["attn_block_bwd"] = fp32_check(torch, f"attn_block_bwd B={TB} S={TS}", ("dx",), (got,),
                                            (plain,), (exact,), (planted,))
        del got, plain, planted, exact

        args, cfg = layer_case(torch, TB, TS, False, seed, r=r, dtype=f32)
        got, st = lb.layer_block_bwd_cuda_stages(*args, *cfg)
        gate = st["relu_a"][:, :r].reshape(TB, TS, r) > 0
        print(f"fp32 layer_block_bwd: adapter a's ReLU gate from the kernel ({int(gate.sum())} of "
              f"{gate.numel()} open) fed to the plain fp32 and float64 versions")
        plain = layer_bwd_gated(torch, args, cfg, gate)
        planted = lb.layer_block_bwd_cuda(
            *bf16_operands(torch, args, (0, 1, 2, 4, 6, 7, 8, 9, 13, 15, 17, 19, 21, 23)), *cfg)
        with f64:
            exact = layer_bwd_gated(torch, to_float64(torch, args), cfg, gate)
        errs["layer_block_bwd"] = fp32_check(torch, f"layer_block_bwd B={TB} S={TS} R={r}",
                                             ("dx", "dwda", "dbda", "dwua", "dbua"), got, plain, exact,
                                             planted)
        del got, st, plain, planted, exact

        h, pa, pb, w = adapter_inputs(torch, n, seed, d=d, dtype=f32)
        got, plain = af.adapter_fused_cuda(h, pa, pb, w), af.adapter_fused_reference(h, pa, pb, w)
        rounded = bf16_operands(torch, (h, *pa, *pb), (0, 1, 3, 5, 7))
        planted = af.adapter_fused_cuda(rounded[0], rounded[1:5], rounded[5:9], w)
        with f64:
            exact = af.adapter_fused_reference(*to_float64(torch, (h,)), to_float64(torch, pa),
                                               to_float64(torch, pb), w)
        errs["adapter_fused"] = fp32_check(torch, f"adapter_fused N={n} R={R} D={d}", ("out",), (got,),
                                           (plain,), (exact,), (planted,))
    torch.cuda.synchronize()
    return errs


# #7-#9 in fp32 at ALBEF's sites: the ViT (no bias), a staged key row (text
# self-attention's padding, the fusion cross-attention's zero row) and a
# staged [query][key] tile (the training decoder's causal + padding bias, the
# rerank decoder's packed block-diagonal one, and a per-head tile over
# several ring steps of #8's and #9's one-stage fp32 tile instances).
FP32_FLASH_CASES = [
    ("vit", AB, VIT_S, VIT_S, "none"),
    ("text self", AB, LQ, LQ, "padding"),
    ("fusion cross", AB, LQ, VIT_S, "zero"),
    ("decoder self", AB * ANS_PER_Q, LA, LA, "causal"),
    ("stage-2 packed self", AB * ALBEF_K // PACK, PACK * LA, PACK * LA, "packed"),
    ("edge 257 heads", 2, 257, 193, "heads"),
]


def fp32_cotangent(torch, b, s, seed):
    """An fp32 dO [B, H, S, 64] in the split() layout, as autograd hands it over."""
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    return torch.randn(b, s, DM, generator=g, device="cuda").view(b, s, HEADS, DM // HEADS).transpose(1, 2)


def fp32_attention_pair(torch, label, fwd, bwd, args, dout, bwd_parts):
    """A forward kernel and its backward in fp32 by the float64 criterion
    (``fwd``/``bwd``: (kernel, plain version) pairs; the backward on the kernel
    forward's own o and lse), the planted fault rounding q, k, v (and dO) to
    bf16 -> {part: max abs error against the plain fp32 version}, ``bwd_parts``
    naming the backward's outputs' parts, e.g. (("dq", (0,)), ("dkv", (1, 2)))."""
    f64 = float64_mode(torch)
    got, plain = fwd[0](*args), fwd[1](*args)
    planted = fwd[0](*bf16_operands(torch, args, (0, 1, 2)))
    with f64:
        exact = fwd[1](*to_float64(torch, args))
    check(all(t.dtype == torch.float32 for t in got), f"fp32 {label}: outputs {[t.dtype for t in got]}")
    errs = {"fwd": fp32_check(torch, label, ("o", "lse"), got, plain, exact, planted)}
    bargs = (*args[:4], got[0], dout, got[1], args[4])
    got, plain = bwd[0](*bargs), bwd[1](*bargs)
    planted = bwd[0](*bf16_operands(torch, bargs, (0, 1, 2, 5)))
    with f64:
        exact = bwd[1](*to_float64(torch, bargs))
    names = ("dq", "dk", "dv")
    for part, idx in bwd_parts:
        errs[part] = fp32_check(torch, f"{label} backward", [names[i] for i in idx], [got[i] for i in idx],
                                [plain[i] for i in idx], [exact[i] for i in idx], [planted[i] for i in idx])
    return errs


def fp32_attention_kernels(torch, seed):
    """(a): #5/#6 at the LoRA step's shape with a padding bias and #7-#9 at
    FP32_FLASH_CASES, alone in fp32 by the float64 criterion -> {kernel: max
    abs error against the plain fp32 version} (#7-#9's at the ViT site)."""
    from feddat_tpu_torch.ops import flash as fl
    from feddat_tpu_torch.ops import fused_attention as fa

    f32, scale = torch.float32, 64 ** -0.5
    with torch.no_grad():
        q, k, v, do = fused_inputs(torch, TB, TS, seed, dtype=f32)
        e = fp32_attention_pair(
            torch, f"fused_attention B={TB} H={HEADS} S={TS} padding",
            (fa.fused_attention_fwd_cuda, fa.fused_attention_fwd_ref),
            (fa.fused_attention_bwd_cuda, fa.fused_attention_bwd_ref),
            (q, k, v, padding_bias(torch, TB, TS, seed), scale), do, (("bwd", (0, 1, 2)),))
        errs = {"fused_attention": e["fwd"], "fused_attention_bwd": e["bwd"]}
        del q, k, v, do
        for site, b, sq, skv, kind in FP32_FLASH_CASES:
            q, k, v, bias = flash_case(torch, b, sq, skv, kind, seed, dtype=f32)
            e = fp32_attention_pair(
                torch, f"flash_attention {site} B={b} Sq={sq} Skv={skv} "
                f"bias={'none' if bias is None else list(bias.shape)}",
                (fl.flash_attention_fwd_cuda, fl.flash_attention_fwd_ref),
                (fl.flash_attention_bwd_cuda, fl.flash_attention_bwd_ref),
                (q, k, v, bias, scale), fp32_cotangent(torch, b, sq, seed), (("dq", (0,)), ("dkv", (1, 2))))
            if site == "vit":
                errs.update(flash_attention=e["fwd"], flash_attention_bwd_dq=e["dq"],
                            flash_attention_bwd_dkv=e["dkv"])
            del q, k, v, bias
    torch.cuda.synchronize()
    return errs


def patch_embedding_check(torch, seed):
    """The float32 patch embedding (``models/layers.py::patch_conv2d``, the
    cuDNN convolution of ViLT's and ALBEF's ViT) against float64 with cuDNN's
    TF32 at PyTorch's default (on): at most 8x the error of the same function
    as a plain fp32 matmul (TF32 off), or 2^-20 of its largest magnitude.
    The plain F.conv2d there (what the port ran before) is printed beside it."""
    import torch.nn.functional as F

    from feddat_tpu_torch.models.layers import patch_conv2d

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(B, 3, *CANVAS, generator=g, device="cuda")
    w = torch.randn(DM, 3, 32, 32, generator=g, device="cuda") * 0.02
    bias = torch.randn(DM, generator=g, device="cuda")
    cudnn, default = torch.backends.cudnn, torch.backends.cudnn.allow_tf32
    cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            got = patch_conv2d(x, w, bias, 32)
            tf32 = F.conv2d(x, w, bias, stride=32)
            check(cudnn.allow_tf32, "patch_conv2d left cuDNN's TF32 switched")
    finally:
        cudnn.allow_tf32 = default
    with torch.no_grad():
        exact = F.conv2d(x.double(), w.double(), bias.double(), stride=32)
        cols = F.unfold(x, 32, stride=32)  # [B, 3 * 32 * 32, patches]
        mm = (w.view(DM, -1) @ cols + bias[:, None]).view_as(exact)
    top = exact.abs().max().item()
    errs = [(t.double() - exact).abs().max().item() for t in (got, mm, tf32)]
    lim = max(FP32_FACTOR * errs[1], FP32_FLOOR * top)
    print(f"fp32 patch embedding B={B} {CANVAS[0]}x{CANVAS[1]}, cuDNN TF32 on: max abs error against "
          f"float64: patch_conv2d {errs[0]:.3e}, fp32 matmul {errs[1]:.3e}, F.conv2d with TF32 "
          f"{errs[2]:.3e} (max |ref| {top:.3e}); limit {lim:.3e}")
    check(errs[0] <= lim, f"the fp32 patch embedding is not at fp32 error: {errs}")


def fp32_agreement(torch, what, kernel, exact, loss_keys=("loss", "loss_shared")):
    """The fp32 path's gradient sets and losses against the plain fp32 path's."""
    for stage in exact["grads"]:
        k, kw, kn = set_error(torch, kernel["grads"][stage], exact["grads"][stage])
        print(f"fp32: {what} {stage} gradients vs plain fp32: relative Frobenius {k:.3e} (worst tensor "
              f"{kw:.3e} {kn}); limit {FP32_GRAD_TOL:.0e}")
        check(k <= FP32_GRAD_TOL, f"fp32 {what}: {stage} gradients disagree: {k}")
    for key in loss_keys:
        k, e = float(kernel[key]), float(exact[key])
        print(f"fp32: {what} {key}: kernel path {k:.8f}, plain fp32 {e:.8f} (relative {abs(k - e) / abs(e):.2e})")
        check(abs(k - e) <= FP32_LOSS_TOL * abs(e), f"fp32 {what}: {key} disagrees: {k} vs {e}")


def fp32_paths(torch, seed):
    """(c): the slice's path in fp32 through the normal entry points ->
    each fp32 kernel's launches on it (the step's, the forward's)."""
    from feddat_tpu_torch.configs.core import FederatedConfig, OptimizerConfig, PEFTMode, TrainConfig
    from feddat_tpu_torch.federated.engine import FederatedTrainer
    from feddat_tpu_torch.train import dat
    from feddat_tpu_torch.train.forwards import to_device

    model = build_trainer_model(torch, seed, "layer", dtype="float32")
    layers = model.config.num_layers
    params = {k: v.detach() for k, v in model.state_dict().items()}
    batch = to_device(next(train_client(TRAIN_CLIENTS[0], TB, 0, seed).train_batches(0)), "cuda")
    step, part, opt = make_steps(model, params)
    state0 = dat.init_train_state(params, part, opt, torch.Generator().manual_seed(seed))
    reset_counts()
    _, m = step(state0, batch)
    torch.cuda.synchronize()
    fused = read_counts()
    want = {**NO_LAUNCHES, "attn_block": 2 * layers, "layer_block_bwd": 2 * layers}
    print(f"fp32: fused DAT step, attn_impl='layer', float32, B={TB} S={TS}: launches {counts_text(fused)}")
    check(fused == want, f"fp32 fused step launches {fused}, expected {want}")
    exact_model = build_trainer_model(torch, seed, "auto", model.state_dict(), "float32")
    before = read_counts()
    exact = {f: make_steps(exact_model, params, f)[0](state0, batch)[1] for f in (True, False)}
    torch.cuda.synchronize()
    check(read_counts() == before, "the plain path launched a kernel")
    del exact_model
    fp32_agreement(torch, "fused step, layer kernels", m, exact[True])

    block_model = build_trainer_model(torch, seed, "block", model.state_dict(), "float32", fused=True)
    reset_counts()
    _, bm = make_steps(block_model, params, fused=False)[0](state0, batch)
    torch.cuda.synchronize()
    std = read_counts()
    want = {**NO_LAUNCHES, "attn_block": 3 * layers, "attn_block_bwd": 2 * (layers - 1),
            "adapter_fused": 2 * layers}
    print(f"fp32: standard DAT step, attn_impl='block', fused ensemble, float32: launches {counts_text(std)}")
    check(std == want, f"fp32 standard step launches {std}, expected {want}")
    fp32_agreement(torch, "standard step, block kernels", bm, exact[False])
    del block_model, m, bm, exact
    torch.cuda.empty_cache()

    clients = {k: train_client(k, 2 * TB, TB, seed + 1 + i) for i, k in enumerate(TRAIN_CLIENTS)}
    cfg = TrainConfig(peft_mode=PEFTMode.DAT, optimizer=OptimizerConfig(),
                      federated=FederatedConfig(comm_rounds=1, local_epochs=1, eval_every=1),
                      num_epochs=1, seed=seed)
    trainer = FederatedTrainer(model, params, clients, cfg, use_fused_dat=True)
    reset_counts()
    trainer.run_round(0)
    entry = trainer.evaluate_round(0)
    torch.cuda.synchronize()
    rounds = read_counts()
    print(f"fp32: FederatedTrainer round of {len(clients)} clients x 2 fused steps, float32, 'layer': "
          f"launches {counts_text(rounds)}; evaluate_dat {entry['scores']}")
    check(rounds["layer_block_bwd"] == 2 * 2 * len(clients) * layers
          and rounds["attn_block_bwd"] == rounds["fused_attention"] == 0, f"fp32 round launches {rounds}")
    for key, scores in entry["scores"].items():
        check(len(scores) == 3 and all(math.isfinite(v) and 0.0 <= v <= 100.0 for v in scores),
              f"fp32: bad evaluate_dat scores for {key}: {scores}")
    moved = [k for k, v in trainer.server_params.items() if "adapter_1" in k and not torch.equal(v, params[k])]
    check(len(moved) == 4 * layers and all(bool(torch.isfinite(trainer.server_params[k]).all()) for k in moved),
          "fp32: FedAvg did not update every adapter_1 tensor on the server")
    del trainer, model, params, state0, batch
    torch.cuda.empty_cache()

    pred = build_predictor(torch, seed, "block", True, dtype="float32")
    imgs, qs = synthetic_requests(B, seed)
    batch = pred._preprocess(imgs, qs)
    reset_counts()
    probs = pred.forward(batch)
    torch.cuda.synchronize()
    serve = read_counts()
    want = {**NO_LAUNCHES, "attn_block": layers, "adapter_fused": layers}
    print(f"fp32: ViltVqaPredictor forward, float32, 'block' + fuse_ln, B={B} S={S}: launches "
          f"{counts_text(serve)}")
    check(serve == want, f"fp32 serving forward launches {serve}, expected {want}")
    plain = build_predictor(torch, seed, "auto", False, state=pred.model.state_dict(), dtype="float32")
    probs_plain = plain.forward(batch)
    diff, top = float(abs(probs - probs_plain).max()), float(probs_plain.max())
    agree = int((probs.argmax(-1) == probs_plain.argmax(-1)).sum())
    print(f"fp32: serving forward vs plain fp32 path: probabilities max_abs_diff={diff:.3e} (max prob "
          f"{top:.3e}); top-1 agreement {agree}/{B}")
    check(agree == B, f"fp32 serving: top-1 answers disagree in {B - agree} of {B}")
    return {"attn_block": fused["attn_block"], "layer_block_bwd": fused["layer_block_bwd"],
            "attn_block_bwd": std["attn_block_bwd"], "adapter_fused": serve["adapter_fused"]}


def fp32_attention_paths(torch, seed):
    """(b): the "fused" and "flash" routes in fp32 through the normal entry
    points at full width: ViLT-B/32 LoRA on "fused" (one step, its gradients
    against the plain fp32 path, one FederatedTrainer round), ALBEF's fused
    DAT step on "flash" with dropout off and AlbefVqaPredictor's rank_answer
    on "flash" -> each fp32 kernel's launches on its path."""
    from feddat_tpu_torch.configs.core import FederatedConfig, OptimizerConfig, PEFTMode, TrainConfig
    from feddat_tpu_torch.federated.engine import FederatedTrainer
    from feddat_tpu_torch.train import dat
    from feddat_tpu_torch.train.forwards import to_device

    out = {}
    batch = to_device(next(peft_client(TRAIN_CLIENTS[0], TB, 0, seed).train_batches(0)), "cuda")
    model = peft_model(torch, "lora", seed, "fused", dtype="float32")
    layers = model.config.num_layers
    params = {k: v.detach() for k, v in model.state_dict().items()}
    step, part, opt = peft_step(model, "lora", params)
    state0 = dat.init_train_state(params, part, opt, torch.Generator().manual_seed(seed))
    reset_counts()
    _, m = step(state0, batch)
    torch.cuda.synchronize()
    got = read_counts()
    want = {**NO_LAUNCHES, "fused_attention": layers, "fused_attention_bwd": layers}
    print(f"fp32: LoRA step, attn_impl='fused', float32, B={TB} S={TS}: launches {counts_text(got)}; "
          f"loss {float(m['loss']):.6f}")
    check(got == want, f"fp32 LoRA step launches {got}, expected {want}")
    out.update(fused_attention=got["fused_attention"], fused_attention_bwd=got["fused_attention_bwd"])
    kernel = peft_grads(torch, model, params, part, batch)
    before = read_counts()
    exact = peft_grads(torch, peft_model(torch, "lora", seed, "auto", "float32", state=model.state_dict()),
                       params, part, batch)
    torch.cuda.synchronize()
    check(read_counts() == before, "the plain path launched a kernel")
    fp32_agreement(torch, "LoRA step, fused kernels", kernel, exact, ("loss",))
    del kernel, exact, m, state0

    clients = {k: peft_client(k, 2 * TB, TB, seed + 1 + i) for i, k in enumerate(TRAIN_CLIENTS)}
    cfg = TrainConfig(peft_mode=PEFTMode.LORA, optimizer=OptimizerConfig(),
                      federated=FederatedConfig(comm_rounds=1, local_epochs=1, eval_every=1),
                      num_epochs=1, seed=seed, layers_to_freeze=FREEZE_K)
    trainer = FederatedTrainer(model, params, clients, cfg)
    reset_counts()
    trainer.run_round(0)
    torch.cuda.synchronize()
    rounds = read_counts()
    reset_counts()
    entry = trainer.evaluate_round(0)
    torch.cuda.synchronize()
    evals = read_counts()
    steps = 2 * len(clients)
    print(f"fp32: FederatedTrainer LoRA round of {len(clients)} clients x 2 steps, float32, 'fused': "
          f"launches {counts_text(rounds)}; evaluate {entry['scores']}, launches {counts_text(evals)}")
    check(rounds == {**NO_LAUNCHES, "fused_attention": steps * layers, "fused_attention_bwd": steps * layers}
          and evals == {**NO_LAUNCHES, "fused_attention": len(clients) * layers}, "fp32 LoRA round launches")
    for key, score in entry["scores"].items():
        check(math.isfinite(score) and 0.0 <= score <= 100.0, f"fp32: bad evaluate score for {key}: {score}")
    moved = [k for k, v in trainer.server_params.items() if "lora_" in k and not torch.equal(v, params[k])]
    check(len(moved) == 4 * layers and all(bool(torch.isfinite(trainer.server_params[k]).all()) for k in moved),
          f"fp32: FedAvg moved {len(moved)} LoRA tensors, expected {4 * layers}")
    del trainer, clients, model, params, batch
    torch.cuda.empty_cache()

    model = albef_train_model(torch, seed, "flash", "float32", dropout=False)
    cfg = model.cfg
    vit, text = cfg.vision_layers, cfg.bert.fusion_layer
    fusion, dec = cfg.bert.num_layers - text, cfg.decoder_layers
    per_pass = vit + text + 2 * fusion + 2 * dec
    params = {n: t.detach() for n, t in model.state_dict().items()}
    batch = albef_train_batch(torch, AB, seed)
    step, state0 = albef_fused_step(torch, model, params, seed)
    reset_counts()
    _, km = step(state0, batch)
    torch.cuda.synchronize()
    got = read_counts()
    want = {**NO_LAUNCHES, "flash_attention": 2 * per_pass, "flash_attention_bwd_dq": 2 * (per_pass - 3),
            "flash_attention_bwd_dkv": 2 * (per_pass - 3)}
    print(f"fp32: ALBEF fused DAT step, attn_impl='flash', float32, dropout off, B={AB} A={ANS_PER_Q}: "
          f"#7/#8/#9 launches {flash_launches(got)} (expected {flash_launches(want)})")
    check(got == want, f"fp32 ALBEF step launches {got}, expected {want}")
    out.update({k: got[k] for k in FLASH_KEYS[1:]})
    before = read_counts()
    exact = albef_train_model(torch, seed, "auto", "float32", dropout=False, state=model.state_dict())
    em = albef_fused_step(torch, exact, params, seed)[0](state0, batch)[1]
    torch.cuda.synchronize()
    check(read_counts() == before, "the plain path launched a kernel")
    fp32_agreement(torch, "ALBEF fused DAT step, flash kernels", km, em)
    del model, exact, params, batch, step, state0, km, em
    torch.cuda.empty_cache()

    pred = albef_predictor(torch, seed, "flash", "float32")
    imgs, qs = albef_requests(AB, seed)
    reset_counts()
    answers = pred.predict(imgs, qs, top_k=5)
    torch.cuda.synchronize()
    got = read_counts()
    want = {**NO_LAUNCHES, "flash_attention": 54}
    print(f"fp32: rank_answer through AlbefVqaPredictor.predict, attn_impl='flash', float32, B={AB}, "
          f"k={ALBEF_K} of {len(ALBEF_ANSWERS)}: launches {counts_text(got)}; first answers {answers[0][:2]}")
    check(got == want, f"fp32 rank_answer launches {got}, expected {want}")
    out["flash_attention"] = got["flash_attention"]
    batch = pred._preprocess(imgs, qs)
    exact = albef_predictor(torch, seed, "auto", "float32")
    exact.model.load_state_dict(pred.model.state_dict())
    ids, probs = pred.rank(batch)
    before = read_counts()
    eids, eprobs = exact.rank(batch)
    torch.cuda.synchronize()
    check(read_counts() == before, "the plain path launched a kernel")
    agree = int((ids[:, 0] == eids[:, 0]).sum())
    diff = float(abs(probs[:, 0] - eprobs[:, 0]).max())
    print(f"fp32: rank_answer vs plain fp32 path: top-1 agreement {agree}/{AB}; top-1 probabilities "
          f"max_abs_diff {diff:.3e}")
    check(agree == AB, f"fp32 rank_answer: top-1 answers disagree in {AB - agree} of {AB}")
    del pred, exact
    torch.cuda.empty_cache()
    return out


def fp32_attention_times(torch, seed):
    """(c): #5-#9's fp32 rows (kernel, plain version, the library call in fp32
    with TF32 off, the bound at the TF32 rate or bytes): #5/#6 at the LoRA
    step's shape, #7-#9 at ALBEF's ViT site; and #8/#9's one-stage fp32
    tile instances' device times beside the bf16 kernels' at the rerank
    decoder's packed shape."""
    import torch.nn.functional as F

    from feddat_tpu_torch.ops import flash as fl
    from feddat_tpu_torch.ops import fused_attention as fa

    f32, scale, rows = torch.float32, 64 ** -0.5, {}
    q, k, v, do = fused_inputs(torch, TB, TS, seed, dtype=f32)
    bias = padding_bias(torch, TB, TS, seed)
    with torch.no_grad():
        o, lse = fa.fused_attention_fwd_cuda(q, k, v, bias, scale)
    rows["fused_attention"] = time_row(
        torch, f"fused_attention fp32 B={TB} S={TS}", lambda: fa.fused_attention_fwd_cuda(q, k, v, bias, scale),
        lambda: fa.fused_attention_fwd_ref(q, k, v, bias, scale),
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias),
        fused_attention_bound(TB, TS, False, f32=True), "SDPA in fp32 with the mask, TF32 off")
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, attn_mask=bias)
    rows["fused_attention_bwd"] = time_row(
        torch, f"fused_attention_bwd fp32 B={TB} S={TS}",
        lambda: fa.fused_attention_bwd_cuda(q, k, v, bias, o, do, lse, scale),
        lambda: fa.fused_attention_bwd_ref(q, k, v, bias, o, do, lse, scale),
        lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
        fused_attention_bound(TB, TS, True, f32=True), "autograd.grad through SDPA in fp32, TF32 off")
    del out, leaves, q, k, v, do, o, lse

    q, k, v, _ = flash_case(torch, AB, VIT_S, VIT_S, "none", seed, dtype=f32)
    do = fp32_cotangent(torch, AB, VIT_S, seed)
    with torch.no_grad():
        o, lse = fl.flash_attention_fwd_cuda(q, k, v, None, scale)
        run_dq, run_dkv, _ = fl.flash_bwd_launchers(q, k, v, None, o, do, lse, scale)
        run_dq()  # #8's launch writes the term planes that #9's reads
    rows["flash_attention"] = time_row(
        torch, f"flash_attention fp32 vit B={AB} S={VIT_S}", lambda: fl.flash_attention_fwd_cuda(q, k, v, None, scale),
        lambda: fl.flash_attention_fwd_ref(q, k, v, None, scale), lambda: F.scaled_dot_product_attention(q, k, v),
        flash_bound(AB, VIT_S, VIT_S, 0, f32=True), "SDPA in fp32, TF32 off")
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves)
    for name, part, run in (("flash_attention_bwd_dq", "dq", run_dq), ("flash_attention_bwd_dkv", "dkv", run_dkv)):
        rows[name] = time_row(
            torch, f"{name} fp32 B={AB} S={VIT_S}", run,
            lambda: fl.flash_attention_bwd_ref(q, k, v, None, o, do, lse, scale),
            lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
            flash_bwd_bound(AB, VIT_S, VIT_S, 0, part, f32=True),
            "autograd.grad through SDPA in fp32, TF32 off: dq, dk, dv; plain: the same")
    del out, leaves

    site = next(c for c in FP32_FLASH_CASES if c[0] == "stage-2 packed self")
    times = {}
    for dtype in (torch.bfloat16, f32):
        q, k, v, bias = flash_case(torch, *site[1:], seed, dtype=dtype)
        do = fp32_cotangent(torch, site[1], site[2], seed).to(dtype)
        with torch.no_grad():
            o, lse = fl.flash_attention_fwd_cuda(q, k, v, bias, scale)
            run_dq, run_dkv, _ = fl.flash_bwd_launchers(q, k, v, bias, o, do, lse, scale)
            run_dq()
        times[dtype] = [device_ms(torch, run) for run in (run_dq, run_dkv)]
    print(f"time flash backward, bias tile ({site[0]} B={site[1]} Sq=Skv={site[2]}): #8 {times[f32][0]:.4f} "
          f"and #9 {times[f32][1]:.4f} ms device in fp32 (one ring stage) against {times[torch.bfloat16][0]:.4f} "
          f"and {times[torch.bfloat16][1]:.4f} in bf16 (two)")
    return rows


def fp32_times(torch, seed):
    """(d): each fp32 kernel's row (kernel, plain version, the library chain
    in fp32 with TF32 off, the bound at the TF32 rate or bytes; #1 with its
    launches' device times), and #4 in bf16 at bottlenecks 96 and 192."""
    f32 = torch.float32
    rows = {"attn_block": time_attn_block(torch, TB, TS, seed, dtype=f32),
            "attn_block_bwd": attn_bwd_row(torch, TB, TS, True, seed, dtype=f32)[0],
            "layer_block_bwd": layer_bwd_row(torch, TB, TS, True, seed, dtype=f32)[0],
            "adapter_fused": time_adapter(torch, B * S, seed, dtype=f32)}
    for r in WIDE_BOTTLENECKS[1:]:
        layer_bwd_row(torch, TB, TS, True, seed, r=r)
    return rows


def phase_fp32(torch, seed):
    """Phase 19 -> ({fp32 kernel: max abs err}, {fp32 kernel: launches}, {row: time row})."""
    from feddat_tpu_torch.train import compiled

    with compiled.disable_graphs():
        errs = fp32_kernels(torch, seed)
        errs.update(fp32_attention_kernels(torch, seed))
        patch_embedding_check(torch, seed)
        for r in WIDE_BOTTLENECKS:
            layer_bwd_parity(torch, TB, TS, True, seed, r=r)
        torch.cuda.empty_cache()
        launches = fp32_paths(torch, seed)
        torch.cuda.empty_cache()
        launches.update(fp32_attention_paths(torch, seed))
        torch.cuda.empty_cache()
        rows = fp32_times(torch, seed)
        rows.update(fp32_attention_times(torch, seed))
    torch.cuda.empty_cache()
    return errs, launches, rows


# -------------------------------------------------------- phase 20: shapes
# (a) the kernels alone at the head dims, widths and adapter widths JAX's
# kernels take and no full-width model here has; (b) two public encoders'
# layer geometries at full width; (c) the JAX CLI's --smoke widths.
SHAPE_HEAD_DIMS = (8, 12, 16, 32, 80, 128, 256)
SHAPE_BLOCKS = ((32, 4, 64), (48, 4, 96), (192, 3, 768))  # (Dm, heads, F)
SHAPE_ADAPTER_WIDTHS = (32, 48, 100, 192)
# (label, Dm, heads, F, adapter reduction factor): ViT-H/14 (Dosovitskiy et
# al. 2021, Table 1: width 1280, 16 heads, MLP 5120) and DeiT-Ti (Touvron et
# al. 2021, Table 1: width 192, 3 heads, MLP 768) as a ViLT tower's layer
SHAPE_GEOMETRIES = (("ViT-H/14", 1280, 16, 5120, 16), ("DeiT-Ti", 192, 3, 768, 16))
SMOKE_VILT = ("smoke ViLT", 32, 4, 64, 4)  # feddat_tpu/cli.py:549-553
# Depth cut to 2 layers.  The steps run at the training batch TB=64, where
# the train phase's gradient rule is set: at B=16 over 2 layers a few ReLU
# gate flips of one adapter-down tensor decide a gradient set's error, and
# the rule read the unchanged head-dim-64 kernels at 2.30x the plain bf16
# path's (width 1280 in heads of 64, seed 2; PERF.md §6).  The
# serving forward runs at the serving batch B=16, ALBEF's step at B=16 x 4.
SHAPE_LAYERS = 2


@contextlib.contextmanager
def widths(dm, heads, ff=None):
    """The kernel helpers above (attn_inputs, layer_case, fused_inputs,
    flash_case, ...) at width ``dm`` in ``heads`` heads and FFN width ``ff``:
    DM, HEADS and FF rebound for the duration."""
    g = globals()
    old = g["DM"], g["HEADS"], g["FF"]
    g["DM"], g["HEADS"], g["FF"] = dm, heads, ff or old[2]
    try:
        yield
    finally:
        g["DM"], g["HEADS"], g["FF"] = old


@contextlib.contextmanager
def model_widths(vilt=None, albef=False):
    """``create_model`` (feddat_tpu_torch.models) building its ViLT at
    ``vilt`` = (Dm, heads, F, reduction factor) with SHAPE_LAYERS layers, or
    its ALBEF at the JAX CLI's --smoke widths (feddat_tpu/cli.py:524-545):
    the config classes it reads, with those fields set, for the duration."""
    import dataclasses

    from feddat_tpu_torch import models
    from feddat_tpu_torch.configs.core import AlbefBertConfig

    real = models.ViltModelConfig, models.AlbefModelConfig

    def vilt_cfg(**kw):
        dm, heads, ff, rf = vilt
        kw["adapter"] = dataclasses.replace(kw["adapter"], reduction_factor=rf)
        return real[0](hidden_size=dm, num_heads=heads, intermediate_size=ff, num_layers=SHAPE_LAYERS, **kw)

    def albef_cfg(**kw):
        bert = AlbefBertConfig(hidden_size=32, num_layers=4, num_heads=4, intermediate_size=64,
                               hidden_dropout=0.0, attention_dropout=0.0, fusion_layer=2, encoder_width=32)
        kw["adapter"] = dataclasses.replace(kw["adapter"], reduction_factor=4)
        return real[1](image_res=64, patch_size=32, vision_width=32, vision_layers=2, vision_heads=4,
                       bert=bert, decoder_layers=2, **kw)

    if vilt is not None:
        models.ViltModelConfig = vilt_cfg
    if albef:
        models.AlbefModelConfig = albef_cfg
    try:
        yield
    finally:
        models.ViltModelConfig, models.AlbefModelConfig = real


def shapes_kernels(torch, seed):
    """(a) -> the number of parity cases held."""
    from feddat_tpu_torch.ops import flash as fl
    from feddat_tpu_torch.ops import fused_attention as fa

    f32, scale, cases = torch.float32, 64 ** -0.5, 0
    fused_pair = ((fa.fused_attention_fwd_cuda, fa.fused_attention_fwd_ref),
                  (fa.fused_attention_bwd_cuda, fa.fused_attention_bwd_ref))
    flash_pair = ((fl.flash_attention_fwd_cuda, fl.flash_attention_fwd_ref),
                  (fl.flash_attention_bwd_cuda, fl.flash_attention_bwd_ref))
    for d in SHAPE_HEAD_DIMS:
        with widths(2 * d, 2):
            check(fa.head_dim_kernels(d) == ("hd64" if d == 64 else "any"), f"head dim {d}'s kernels")
            for b, s in ((2, 65), (1, 129)):  # either side of the 64-row tiles
                fused_parity(torch, b, s, seed)
            for site, b, sq, skv, kind in ((f"hd {d} padding", 2, 129, 63, "padding"),
                                           (f"hd {d} heads", 2, 65, 130, "heads")):
                flash_parity(torch, site, b, sq, skv, kind, seed)
                flash_bwd_parity(torch, site, b, sq, skv, kind, seed)
            with torch.no_grad():
                q, k, v, do = fused_inputs(torch, 2, 65, seed, dtype=f32)
                fp32_attention_pair(torch, f"fused_attention hd={d} B=2 S=65 padding", *fused_pair,
                                    (q, k, v, padding_bias(torch, 2, 65, seed), scale), do,
                                    (("bwd", (0, 1, 2)),))
                q, k, v, bias = flash_case(torch, 2, 65, 130, "heads", seed, dtype=f32)
                fp32_attention_pair(torch, f"flash_attention hd={d} B=2 Sq=65 Skv=130 heads", *flash_pair,
                                    (q, k, v, bias, scale), fp32_cotangent(torch, 2, 65, seed),
                                    (("dq", (0,)), ("dkv", (1, 2))))
            cases += 10
    for dm, heads, ff in SHAPE_BLOCKS:
        with widths(dm, heads, ff):
            for b, s, ln in ((2, 65, True), (1, 129, False)):
                attn_parity(torch, b, s, ln, seed)
                attn_bwd_parity(torch, b, s, ln, seed)
            for use_b in (False, True):
                layer_bwd_parity(torch, 4, 65, use_b, seed, r=dm // 4)
            fp32_kernels(torch, seed, 2, 65, 129, dm // 4, dm)
            cases += 10
    for d in SHAPE_ADAPTER_WIDTHS:
        adapter_parity(torch, 129, seed, R, d)
        cases += 1
    torch.cuda.synchronize()
    shape_functions()
    return cases


def shape_functions():
    """The wrappers' shape functions (the fp32 workspaces they allocate, #4's
    adapter width) against the libraries' own at every shape of (a)."""
    import ctypes

    from feddat_tpu_torch.ops import _build
    from feddat_tpu_torch.ops import flash as fl
    from feddat_tpu_torch.ops import fused_attention as fa
    from feddat_tpu_torch.ops import layer_block as lb

    fused, flash = _build.load("fused_attention"), _build.load("flash_attention")
    fused.fused_attention_workspace.argtypes = [ctypes.c_int] * 6
    flash.flash_attention_workspace.argtypes = [ctypes.c_int] * 7
    width = _build.load("layer_block").layer_block_padded_width
    fused.fused_attention_workspace.restype = flash.flash_attention_workspace.restype = ctypes.c_longlong
    width.argtypes, width.restype = [ctypes.c_int], ctypes.c_int
    bad = []
    for d in SHAPE_HEAD_DIMS:
        for backward in (0, 1):
            if fa.fused_workspace_bytes(2, 3, 65, d, backward, True) != fused.fused_attention_workspace(
                    2, 3, 65, d, backward, 1):
                bad.append(("fused", d, backward))
            if fl.flash_workspace_bytes(2, 3, 65, 130, d, backward, True) != flash.flash_attention_workspace(
                    2, 3, 65, 130, d, backward, 1):
                bad.append(("flash", d, backward))
    widths_ = [b[0] for b in SHAPE_BLOCKS] + [g[1] for g in SHAPE_GEOMETRIES] + [DM]
    bad += [("width", dm) for dm in widths_ if lb.padded_width(dm) != width(dm)]
    print(f"shapes: the wrappers' fp32 workspaces and #4's adapter width against the libraries' at "
          f"head dims {list(SHAPE_HEAD_DIMS)} and widths {widths_}: {len(bad)} differ")
    check(not bad, f"the wrappers' shape functions disagree with the libraries': {bad}")


def shape_batch(torch, labels, seed):
    """One synthetic VQA batch of TB questions at the training canvas (S=185)."""
    from feddat_tpu_torch.data.synthetic import SyntheticVQAClient
    from feddat_tpu_torch.train.forwards import to_device

    client = SyntheticVQAClient(TRAIN_CLIENTS[0], num_train=TB, num_eval=0, num_labels=labels,
                                vocab_size=30522, text_len=TEXT_LEN, image_size=TCANVAS,
                                batch_size=TB, val_batch_size=TB, seed=seed)
    return to_device(next(client.train_batches(0)), "cuda")


def shapes_paths(torch, seed, label, dm, heads, ff, rf):
    """(b)/(c): one ViLT DAT model at this width through the five kernel
    paths, each against the plain path by its phase's rule -> {path: launches}."""
    from feddat_tpu_torch.train import dat

    tag = f"shapes: {label} (Dm {dm}, {heads} heads of {dm // heads}, F {ff}, R {dm // rf}) S={TS}"
    out = {}

    def launched(path, run, want):
        reset_counts()
        result = run()
        torch.cuda.synchronize()
        got = read_counts()
        print(f"{tag}: {path}: launches {counts_text(got)}")
        check(got == want and all(v > 0 for k, v in want.items() if v), f"{label} {path}: launches {got}, expected {want}")
        out[path] = got
        return result

    with model_widths(vilt=(dm, heads, ff, rf)):
        model = build_trainer_model(torch, seed, "layer")
        c = model.config
        check((c.hidden_size, c.num_heads, c.intermediate_size, c.num_layers) == (dm, heads, ff, SHAPE_LAYERS)
              and model.vilt.layers[0].adapter.bottleneck == dm // rf, f"unexpected {label} config {c}")
        layers, sd = c.num_layers, model.state_dict()
        params = {k: v.detach() for k, v in sd.items()}
        batch = shape_batch(torch, NUM_LABELS, seed)
        step, part, opt = make_steps(model, params)
        state0 = dat.init_train_state(params, part, opt, torch.Generator().manual_seed(seed))
        m = launched(f"fused DAT step B={TB} on 'layer'", lambda: step(state0, batch)[1],
                     {**NO_LAUNCHES, "attn_block": 2 * layers, "layer_block_bwd": 2 * layers})
        plain_model = build_trainer_model(torch, seed, "auto", sd)
        exact_model = build_trainer_model(torch, seed, "auto", sd, "float32")
        before = read_counts()
        plain = {f: make_steps(plain_model, params, f)[0](state0, batch)[1] for f in (True, False)}
        exact = {f: make_steps(exact_model, params, f)[0](state0, batch)[1] for f in (True, False)}
        torch.cuda.synchronize()
        check(read_counts() == before, "the plain path launched a kernel")
        grad_agreement(torch, f"{label} fused step, layer kernels", m, plain[True], exact[True])
        block_model = build_trainer_model(torch, seed, "block", sd)
        bm = launched(f"standard DAT step B={TB} on 'block'",
                      lambda: make_steps(block_model, params, fused=False)[0](state0, batch)[1],
                      {**NO_LAUNCHES, "attn_block": 3 * layers, "attn_block_bwd": 2 * (layers - 1)})
        grad_agreement(torch, f"{label} standard step, block kernels", bm, plain[False], exact[False])
        del model, block_model, exact_model, m, bm, plain, exact
        served = build_trainer_model(torch, seed, "block", sd, fused=True)
        requests = {k: v[:B] for k, v in batch.items()}
        with torch.inference_mode():
            logits = launched(f"serving forward B={B} on 'block', fused ensemble",
                              lambda: served(TRAIN_CLIENTS[0], requests, adapter_mode="ensemble")[1],
                              {**NO_LAUNCHES, "attn_block": layers, "adapter_fused": layers})
            ref = plain_model(TRAIN_CLIENTS[0], requests, adapter_mode="ensemble")[1]
        serving_agreement(f"{tag}: serving forward:", torch.softmax(logits.float(), -1).cpu(),
                          torch.softmax(ref.float(), -1).cpu(), B)
        del served, plain_model, logits, ref
        lbatch = shape_batch(torch, PEFT_LABELS, seed + 1)
        for route, keys in (("fused", ("fused_attention", "fused_attention_bwd")), ("flash", FLASH_KEYS)):
            lm = peft_model(torch, "lora", seed, route)
            lsd = lm.state_dict()
            lparams = {k: v.detach() for k, v in lsd.items()}
            lstep, lpart, lopt = peft_step(lm, "lora", lparams)
            lstate = dat.init_train_state(lparams, lpart, lopt, torch.Generator().manual_seed(seed))
            launched(f"LoRA step B={TB} on '{route}'", lambda: lstep(lstate, lbatch),
                     {**NO_LAUNCHES, **{k: layers for k in keys}})
            kernel = peft_grads(torch, lm, lparams, lpart, lbatch)
            before = read_counts()
            plain = peft_grads(torch, peft_model(torch, "lora", seed, "auto", state=lsd), lparams, lpart, lbatch)
            exact = peft_grads(torch, peft_model(torch, "lora", seed, "auto", "float32", state=lsd), lparams,
                               lpart, lbatch)
            torch.cuda.synchronize()
            check(read_counts() == before, "the plain path launched a kernel")
            grad_agreement(torch, f"{label} LoRA on {route}", kernel, plain, exact, ("loss",))
            del lm, kernel, plain, exact
    torch.cuda.empty_cache()
    return out


def shapes_albef_smoke(torch, seed):
    """(c): ALBEF at the JAX CLI's --smoke widths on "flash": one fused DAT
    step (dropout off, as the smoke config has it) with its losses against
    the plain fp32 path's, and rank_answer behind AlbefVqaPredictor with its
    question states and stage-1 logits against the plain paths by phase 6's
    rule -> {path: launches}."""
    from feddat_tpu_torch.configs.core import PEFTMode
    from feddat_tpu_torch.data.tokenizer import WordPieceTokenizer
    from feddat_tpu_torch.models import create_model
    from feddat_tpu_torch.serving import AlbefVqaPredictor

    out = {}
    with model_widths(albef=True):
        models = {}
        for name, impl, dt in (("kernel", "flash", "bfloat16"), ("plain", "auto", "bfloat16"),
                               ("exact", "auto", "float32")):
            models[name], cfg = create_model("albef_no_distill", {}, PEFTMode.DAT, 4, dt, attn_impl=impl,
                                             seed=seed if name == "kernel" else None)
            if name != "kernel":
                models[name].load_state_dict(models["kernel"].state_dict())
    check((cfg.vision_width, cfg.vision_heads, cfg.bert.hidden_size, cfg.image_res) == (32, 4, 32, 64),
          f"unexpected smoke ALBEF config {cfg}")
    tag = "shapes: smoke ALBEF (ViT and BERT width 32, 4 heads of 8, F 64) on 'flash'"
    params = {k: v.detach() for k, v in models["kernel"].state_dict().items()}
    batch = albef_train_batch(torch, B, seed, res=cfg.image_res)
    metrics = {}
    for name, model in models.items():
        step, state0 = albef_fused_step(torch, model, params, seed)
        reset_counts()
        metrics[name] = step(state0, batch)[1]
        torch.cuda.synchronize()
        if name == "kernel":
            out["fused DAT step"] = read_counts()
    got = out["fused DAT step"]
    print(f"{tag}: fused DAT step B={B}x{ANS_PER_Q}: launches {counts_text(got)}")
    check(all(got[k] > 0 for k in FLASH_KEYS) and all(v == 0 for k, v in got.items() if k not in FLASH_KEYS),
          f"smoke ALBEF step launches {got}")
    for key in ("loss", "loss_shared"):
        k, p, e = (float(metrics[n][key]) for n in ("kernel", "plain", "exact"))
        print(f"{tag}: {key}: kernel path {k:.6f}, plain bf16 {p:.6f}, plain fp32 {e:.6f}")
        check(math.isfinite(k) and abs(k - e) <= TRAIN_LOSS_TOL * abs(e), f"smoke ALBEF {key}: {k} vs {e}")
    tok = WordPieceTokenizer.from_vocab_file(str(REPO / "tests" / "fixtures" / "vocab30k.txt"))
    preds = {n: AlbefVqaPredictor(m, None, tok, ALBEF_ANSWERS, batch_size=AB, k=ALBEF_K, max_question_len=LQ,
                                  max_answer_len=LA, adapter_mode="ensemble", batch_buckets=(1,))
             for n, m in models.items()}
    imgs, qs = albef_requests(AB, seed)
    reset_counts()
    answers = preds["kernel"].predict(imgs, qs, top_k=5)
    torch.cuda.synchronize()
    got = out["rank_answer"] = read_counts()
    print(f"{tag}: rank_answer through AlbefVqaPredictor.predict, B={AB}, k={ALBEF_K}: launches "
          f"{counts_text(got)}; first answers {[r[0] for r in answers[:2]]}")
    check(got["flash_attention"] > 0 and sum(got.values()) == got["flash_attention"], f"rank_answer launches {got}")
    check(len(answers) == AB and all(len(r) == 5 for r in answers), "bad smoke ALBEF answers")
    t = {k: torch.from_numpy(v).cuda() for k, v in preds["kernel"]._preprocess(imgs, qs).items()}
    stages = {n: albef_stages(torch, p, t) for n, p in preds.items()}
    for i, what in enumerate(("question states", "stage-1 logits")):
        k_err = rel_norm(stages["kernel"][i], stages["exact"][i])
        p_err = rel_norm(stages["plain"][i], stages["exact"][i])
        lim = max(ALBEF_FACTOR * p_err, ALBEF_FLOOR)
        print(f"{tag}: {what} vs plain fp32: kernel path {k_err:.3e}, plain bf16 path {p_err:.3e}; limit {lim:.3e}")
        check(k_err <= lim, f"smoke ALBEF {what} disagree: {k_err} > {lim}")
    del models, preds
    torch.cuda.empty_cache()
    return out


def phase_shapes(torch, seed):
    """Phase 20 (see the module docstring) -> {path: launches} of (b) and (c)."""
    from feddat_tpu_torch.train import compiled

    launches = {}
    with compiled.disable_graphs():
        t0 = time.perf_counter()
        cases = shapes_kernels(torch, seed)
        print(f"shapes (a): #5-#9 at head dims {list(SHAPE_HEAD_DIMS)}, #1/#3/#4 at (Dm, heads, F) "
              f"{list(SHAPE_BLOCKS)}, #2 at widths {list(SHAPE_ADAPTER_WIDTHS)}, bf16 and float32: "
              f"{cases} cases within their limits in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        for geometry in SHAPE_GEOMETRIES:
            for path, got in shapes_paths(torch, seed, *geometry).items():
                launches[f"{geometry[0]} {path}"] = got
        print(f"shapes (b): {', '.join(g[0] for g in SHAPE_GEOMETRIES)} layers ({SHAPE_LAYERS} deep, S={TS}; "
              f"steps at B={TB}, serving at B={B}) through 5 paths each against the plain path; every "
              f"kernel of each path launched in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        for path, got in shapes_paths(torch, seed, *SMOKE_VILT).items():
            launches[f"smoke ViLT {path}"] = got
        for path, got in shapes_albef_smoke(torch, seed).items():
            launches[f"smoke ALBEF {path}"] = got
        print(f"shapes (c): the JAX CLI's --smoke ViLT through 5 paths and ALBEF's step and rank_answer "
              f"on 'flash' against the plain path in {time.perf_counter() - t0:.1f} s")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import feddat_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    from feddat_tpu_torch.train import compiled

    t_start = time.perf_counter()

    def done(what):
        print(f"chip_smoke: {what} done at {time.perf_counter() - t_start:.1f} s", flush=True)

    phase_build()
    # the from-disk dataset first: the parity phase holds #1 and #4 on its masks
    root = tempfile.mkdtemp(prefix="chip_smoke_from_disk_")
    atexit.register(shutil.rmtree, root, True)
    write_disk_dataset(root, args.seed)
    # phases 2-9 run the eager path (disable_graphs): the kernels' parity,
    # gradients and times as the earlier slices measured them
    with compiled.disable_graphs():
        errs = phase_parity(torch, args.seed, root)
        done("parity")
        pred, plain, _, requests = phase_serve(torch, args.seed)
        tr = phase_train(torch, args.seed)
        pf = phase_peft(torch, args.seed)
        al = phase_albef(torch, args.seed)
        times = phase_time(torch, pred, plain, requests, args.seed)
        del pred, plain
        times.update(time_backward_kernels(torch, args.seed))
        long_kernel_times(torch, args.seed)
        time_train(torch, tr)
        times.update(time_fused_kernels(torch, args.seed))
        time_peft(torch, pf, args.seed)
        del pf
        torch.cuda.empty_cache()
        flash_rows, _, _ = time_albef(torch, al, args.seed)
        times["flash_attention"] = flash_rows[0][1:]
        del tr, al  # the earlier phases' models
        torch.cuda.empty_cache()
        at = phase_albef_train(torch, args.seed)
        bwd_rows, _, _ = time_albef_train(torch, at, args.seed)
        times.update(bwd_rows)
        del at
        torch.cuda.empty_cache()
    done("the eager phases")
    check(compiled.STATS["captures"] == 0, "an eager phase captured a graph")
    # each kernel's launches per replayed call on the path it serves, the
    # main path of this slice: the fused DAT step for #1 and #4, the standard
    # 'block' step for #3, the serving forward for #2, the LoRA step for #5
    # and #6, one rank_answer for #7, and the fused ALBEF step with dropout
    # live for #8 and #9
    launches = phase_graphs(torch, args.seed)
    done("graphs")
    # this slice's paths: the tuned ALBEF step for #1 and #4, its "block"
    # route for #3
    launches.update(phase_albef_tuned(torch, args.seed))
    done("albef_tuned")
    # this slice's path, from files on disk to answers
    phase_from_disk(torch, args.seed, root)
    done("from_disk")
    # this slice's path: the launch surface, the CLI in processes of its own
    phase_cli(torch, args.seed, root)
    done("cli")
    # this slice's paths: the distill step for #7-#9, the joint DAT step for
    # #1 and #3, the ViLT adapter step for #5 and #6
    launches.update(phase_modes(torch, args.seed, root))
    done("modes")
    # this slice's path: the SPMD engine's round in a world of one, against
    # the sequential engine's
    launches.update(phase_spmd(torch, args.seed))
    done("spmd")
    # this slice's path: the ViLT family's classification tasks on the
    # standard DAT step, their round's #1 and #4
    launches.update(phase_classify(torch, args.seed, root))
    done("classify")
    # this slice's path: the accuracy study's full-width ViLT DAT run on
    # "block", its #1 and #3
    launches.update(phase_study(torch, args.seed))
    done("study")
    # this slice's path: tensor parallelism, two ranks on the card over gloo
    phase_tp(torch, args.seed)
    done("tp")
    # this slice's paths: every kernel route in float32 (#1-#4 on "block" and
    # "layer", #5-#9 on "fused" and "flash")
    t_fp32 = time.perf_counter()
    fp32_errs, fp32_launches, fp32_rows = phase_fp32(torch, args.seed)
    done(f"fp32 (the phase {time.perf_counter() - t_fp32:.1f} s)")
    # this slice's paths: every head dim and width JAX's kernels take, the
    # kernels alone and two full-width layer geometries through every route
    t_shapes = time.perf_counter()
    phase_shapes(torch, args.seed)
    done(f"shapes (the phase {time.perf_counter() - t_shapes:.1f} s)")
    lag = sorted(DEVICE_MS_STATS["lag_us"]) or [math.nan]
    print(f"time device_ms: {DEVICE_MS_STATS['profiles']} profiles, {DEVICE_MS_STATS['again']} taken "
          f"again; closing marker's device start less its launch on the host: median {lag[len(lag) // 2]:.1f} "
          f"us, range [{lag[0]:.1f}, {lag[-1]:.1f}] over {len(DEVICE_MS_STATS['lag_us'])} profiles")
    sources = {
        "attn_block": ("feddat_tpu_torch/csrc/attn_block.cu", "feddat_tpu/ops/attn_block.py:90"),
        "adapter_fused": ("feddat_tpu_torch/csrc/adapter_fused.cu",
                          "feddat_tpu/ops/adapter_fused.py:30"),
        "attn_block_bwd": ("feddat_tpu_torch/csrc/attn_block.cu", "feddat_tpu/ops/attn_block.py:139"),
        "layer_block_bwd": ("feddat_tpu_torch/csrc/layer_block.cu",
                            "feddat_tpu/ops/layer_block.py:126"),
        "fused_attention": ("feddat_tpu_torch/csrc/fused_attention.cu",
                            "feddat_tpu/ops/fused_attention.py:37"),
        "fused_attention_bwd": ("feddat_tpu_torch/csrc/fused_attention.cu",
                                "feddat_tpu/ops/fused_attention.py:60"),
        "flash_attention": ("feddat_tpu_torch/csrc/flash_attention.cu", "feddat_tpu/ops/flash.py:36"),
        "flash_attention_bwd_dq": ("feddat_tpu_torch/csrc/flash_attention.cu",
                                   "feddat_tpu/ops/flash.py:75"),
        "flash_attention_bwd_dkv": ("feddat_tpu_torch/csrc/flash_attention.cu",
                                    "feddat_tpu/ops/flash.py:107"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        k_ms, p_ms, l_ms, bound, bound_by, _ = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name], "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": bound, "bound_by": bound_by, "library_ms": l_ms,
            "dtype": "bfloat16",
        })
    for name in sources:
        src, replaces = sources[name]
        k_ms, p_ms, l_ms, bound, bound_by, _ = fp32_rows[name]
        kernels.append({
            "name": f"{name}_fp32", "route": "cuda", "source": src, "replaces": replaces,
            "launches": fp32_launches[name], "max_abs_err": fp32_errs[name], "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": bound, "bound_by": bound_by, "library_ms": l_ms,
            "dtype": "float32",
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
