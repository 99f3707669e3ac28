"""Time the port's hand-written kernels of this checkout against those of
another source tree, on one CUDA card, by the profiler's device time.

    git archive <commit> feddat_tpu_torch/csrc | tar -x -C logs/parent
    python3 scripts/torch_kernel_ab.py --other logs/parent

Builds ``attn_block.cu``, ``layer_block.cu``, ``flash_attention.cu`` (with
its part ``flash_dp.cu`` where the tree has one), ``fused_attention.cu`` and
``adapter_fused.cu`` of both trees, all at once, this tree's with its own
per-source flags (``_build.nvcc_flags``) and the other's with the package's
common ones (a tree from before the head dims other than 64 has no others),
then times each tree in the order other, this, this, other:

* #1, the attention-block forward with LN1 fused, at the serving shape (B=16,
  S=281) and the ViLT training shape (B=64, S=185);
* #3, the attention-block backward, and #4, the whole-layer backward (ensemble
  on), at the training shape;
* #7 at ALBEF's ViT site (B=16, H=12, S=577, no bias) and at its packed
  decoder site (B=128, Sq=Skv=80, a [128, 1, 80, 80] bias), #8 and #9 at the
  ViT site;
* #5 and #6, the whole-sequence attention forward and backward (a [B, 1, 1,
  S] padding bias), at the training shape and the serving canvas;
* #8 and #9 at ViT-H/14's layer (B=16, 16 heads of 80, S=185, no bias) and
  at head dim 128 (16 heads), csrc/flash_dp.cuh's bodies in a tree that has
  them, each on its tree's own #7 forward; #5, #6 (a padding bias) and #7
  at head dim 80 beside them;
* #2, the DAT ensemble-adapter epilogue, at the serving batch (N = 16 * 281
  rows) and the B=1 bucket (N = 281).  Its C entry point takes a scratch
  pointer and exports ``adapter_fused_workspace``: the other tree must have
  both (a tree that does not cannot be compared here).  The C entry points
  of #1-#9 take an element-type flag, and those of #1 and #5-#9 a
  workspace: a tree whose entry points do not cannot be compared here
  either.  The entry points of #5-#9 take the head dim D (and export
  ``attention_max_head_dim``); a tree from before takes none, and its
  calls here (all at head dim 64) go without it.

#8 and #9 at head dims 80 and 128 are the kernels the current change
redesigned (``csrc/flash_dp.cuh``).  Every other row, #8/#9 at head dim 64
and #5-#7 at head dim 80 among them, runs code the change did not touch:
those are the controls that say how far the turns drift.  Each
time is ``chip_smoke.device_ms`` (median over 10 calls of the summed kernel
durations) beside the CUDA-event wall per call; each tree's first pass also
prints the device time of every launch of one #1 call at both shapes, of one
flash backward call (delta, #8, #9) at the ViT site, of one #6 call at the
training shape and of one #2 call at the serving batch
(``chip_smoke.launch_breakdown``).  Then prints how far the
two trees' outputs lie apart, in bf16 ulps of each element
(``chip_smoke.own_ulps``; relative norm for #4's fp32 adapter gradients and
the lse of #5), and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
SOURCES = ("attn_block", "layer_block", "flash_attention", "fused_attention", "adapter_fused")


def build(trees, out_dir):
    """Every (tree, source)'s nvcc compiles, all started together, then the
    links of libraries with parts (``_build.PARTS``, where the tree has the
    part's source) -> {tree name: {source: library path}}."""
    from feddat_tpu_torch.ops import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, root in trees.items():
        csrc = root / "feddat_tpu_torch" / "csrc"
        for src in SOURCES:
            lib = out_dir / f"{src}_{name}.so"
            parts = tuple(p for p in _build.PARTS.get(src, ()) if (csrc / f"{p}.cu").exists())
            # as each tree builds it: this tree with its per-source flags, the other with the common ones
            flags = _build.nvcc_flags if root == REPO else (lambda _: _build.NVCC_FLAGS)
            compiles, link = _build.build_commands(src, csrc, lib, flags, parts)
            procs[name, src] = ([subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                  text=True) for cmd in compiles], link, lib)
    libs = {}
    for (name, src), (running, link, lib) in procs.items():
        log = ""
        for proc in running:
            log += proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name} {src}.cu (exit {proc.returncode}):\n{log}")
        if link is not None:
            subprocess.run(link, check=True)
        print(f"build {name} {src}: {lib.name}; ptxas: " + " | ".join(_build.ptxas_summary(log)))
        libs.setdefault(name, {})[src] = lib
    return libs


# the wrappers' argument index of the head dim D in each #5-#9 entry point
HEAD_DIM_ARG = (("fused_attention", "fused_attention_fwd", 11), ("fused_attention", "fused_attention_bwd", 16),
                ("flash_attention", "flash_attention_fwd", 12), ("flash_attention", "flash_attention_bwd_dq", 14),
                ("flash_attention", "flash_attention_bwd_dkv", 15))


def without_head_dim(fn, argtypes, at):
    """``fn``, an entry point of a tree from before the head dim argument,
    called with the wrappers' arguments less argument ``at`` (D, 64 here)."""
    fn.argtypes = list(argtypes[:at]) + list(argtypes[at + 1:])
    fn.restype = ctypes.c_int

    def call(*args):
        if args[at] != 64:
            raise ValueError(f"the other tree takes head dim 64 only, not {args[at]}")
        return fn(*args[:at], *args[at + 1:])

    return call


def use(libs):
    """Route the wrappers of #1/#3, #2, #4, #5/#6 and #7-#9 to the given libraries."""
    from feddat_tpu_torch.ops import _build
    from feddat_tpu_torch.ops import adapter_fused as af
    from feddat_tpu_torch.ops import attn_block as ab
    from feddat_tpu_torch.ops import flash as fl
    from feddat_tpu_torch.ops import fused_attention as fa
    from feddat_tpu_torch.ops import layer_block as lb

    for src, path in libs.items():
        lib = ctypes.CDLL(str(path))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _build._LIBS[src] = lib
    for kernel in (ab.KERNEL, ab.KERNEL_BWD, lb.KERNEL, fl.KERNEL, fl.KERNEL_BWD_DQ, fl.KERNEL_BWD_DKV,
                   fa.KERNEL, fa.KERNEL_BWD, af.KERNEL):
        kernel._fn = None
        for source, symbol, at in HEAD_DIM_ARG:
            lib = _build._LIBS[source]
            if (kernel.source, kernel.symbol) == (source, symbol) and not hasattr(lib, "attention_max_head_dim"):
                kernel._fn = without_head_dim(getattr(lib, symbol), kernel.argtypes, at)
    # the workspace sizes and layouts are the tree's own
    for cached in (ab._fwd_workspace, ab._bwd_workspace, af._workspace, lb._workspace, lb._stage_offsets):
        cached.cache_clear()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="root of the other tree (holds feddat_tpu_torch/csrc)")
    ap.add_argument("--build", type=Path, default=REPO / "feddat_tpu_torch" / "_build" / "ab")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from feddat_tpu_torch.ops import adapter_fused as af
    from feddat_tpu_torch.ops import attn_block as ab
    from feddat_tpu_torch.ops import flash as fl
    from feddat_tpu_torch.ops import fused_attention as fa
    from feddat_tpu_torch.ops import layer_block as lb

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    t0 = time.perf_counter()
    libs = build({"other": args.other.resolve(), "this": REPO}, args.build)
    print(f"build: both trees in {time.perf_counter() - t0:.1f} s")

    use(libs["this"])
    fwd_args = cs.attn_inputs(torch, cs.B, cs.S, True, args.seed)
    train_args = cs.attn_inputs(torch, cs.TB, cs.TS, True, args.seed)
    fused = {}  # #5/#6 inputs at the training shape and the serving canvas: q, k, v, dO, bias
    for tag, b, s in (("training", cs.TB, cs.TS), ("serving", cs.B, cs.S)):
        fused[tag] = (*cs.fused_inputs(torch, b, s, args.seed), cs.padding_bias(torch, b, s, args.seed))
    bwd_args = cs.attn_bwd_case(torch, cs.TB, cs.TS, True, args.seed)
    layer_args, cfg = cs.layer_case(torch, cs.TB, cs.TS, True, args.seed)
    scale = 64 ** -0.5
    q, k, v, _ = cs.flash_case(torch, cs.AB, cs.VIT_S, cs.VIT_S, "none", args.seed)
    g = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    do = torch.randn(q.shape, generator=g, device="cuda").bfloat16()
    packed = next(c for c in cs.FLASH_CASES if c[0] == "stage-2 packed self")
    qp, kp, vp, biasp = cs.flash_case(torch, *packed[1:], args.seed)
    adapter = {n: cs.adapter_inputs(torch, n, args.seed) for n in (cs.B * cs.S, cs.S)}
    heads = {}  # head dims 80 and 128 at B=16, S=185, 16 heads: q, k, v, dO (and #5/#6's padding bias)
    for d in (80, 128):
        with cs.widths(16 * d, 16):
            hq, hk, hv, _ = cs.flash_case(torch, cs.B, cs.TS, cs.TS, "none", args.seed)
            heads[d] = (hq, hk, hv, torch.randn(hq.shape, generator=g, device="cuda").bfloat16(),
                        cs.padding_bias(torch, cs.B, cs.TS, args.seed))

    outs, times = {}, {}
    for name in ("other", "this", "this", "other"):
        use(libs[name])
        with torch.no_grad():
            o, lse = fl.flash_attention_fwd_cuda(q, k, v, None, scale)
            run_dq, run_dkv, grads = fl.flash_bwd_launchers(q, k, v, None, o, do, lse, scale)
            run_dq()
            run_dkv()
            got = {"#1": ab.attn_block_cuda(*fwd_args), "#1 training": ab.attn_block_cuda(*train_args),
                   "#3": (ab.attn_block_bwd_cuda(*bwd_args),),
                   "#4": lb.layer_block_bwd_cuda(*layer_args, *cfg), "#7-#9": (o, *grads)}
            head_fns = {}  # each head dim's #8/#9 on this tree's own #7 forward
            for d, (hq, hk, hv, hdo, hb) in heads.items():
                hs = d ** -0.5
                ho, hlse = fl.flash_attention_fwd_cuda(hq, hk, hv, None, hs)
                h_dq, h_dkv, h_grads = fl.flash_bwd_launchers(hq, hk, hv, None, ho, hdo, hlse, hs)
                h_dq()
                h_dkv()
                got[f"#7-#9 hd{d}"] = (ho, *h_grads)
                head_fns[f"#8 hd{d}"], head_fns[f"#9 hd{d}"] = h_dq, h_dkv
            hq, hk, hv, hdo, hb = heads[80]
            fo80, flse80 = fa.fused_attention_fwd_cuda(hq, hk, hv, hb, 80 ** -0.5)
            got["#5/#6 hd80"] = (fo80, flse80, *fa.fused_attention_bwd_cuda(hq, hk, hv, hb, fo80, hdo, flse80,
                                                                           80 ** -0.5))
            fwd = {}  # #6 from this tree's own #5 forward
            for tag, (fq, fk, fv, fdo, fb) in fused.items():
                fo, flse = fwd[tag] = fa.fused_attention_fwd_cuda(fq, fk, fv, fb, scale)
                grads6 = fa.fused_attention_bwd_cuda(fq, fk, fv, fb, fo, fdo, flse, scale)
                got[f"#5/#6 {tag}"] = (fo, flse, *grads6)
            for n, ad_args in adapter.items():
                got[f"#2 N={n}"] = (af.adapter_fused_cuda(*ad_args),)
            torch.cuda.synchronize()
            outs[name] = {key: [t.clone() for t in ts] for key, ts in got.items()}
            fns = {"#1 attn_block serving": lambda: ab.attn_block_cuda(*fwd_args),
                   "#1 attn_block training": lambda: ab.attn_block_cuda(*train_args),
                   "#8 vit": run_dq,
                   "#3 attn_block_bwd": lambda: ab.attn_block_bwd_cuda(*bwd_args),
                   "#4 layer_block_bwd": lambda: lb.layer_block_bwd_cuda(*layer_args, *cfg),
                   "#7 vit": lambda: fl.flash_attention_fwd_cuda(q, k, v, None, scale),
                   "#7 packed": lambda: fl.flash_attention_fwd_cuda(qp, kp, vp, biasp, scale),
                   "#9 vit": run_dkv}
            for tag, (fq, fk, fv, fdo, fb) in fused.items():
                fo, flse = fwd[tag]
                fns[f"#5 fused_attention {tag}"] = (
                    lambda fq=fq, fk=fk, fv=fv, fb=fb: fa.fused_attention_fwd_cuda(fq, fk, fv, fb, scale))
                fns[f"#6 fused_attention_bwd {tag}"] = (
                    lambda fq=fq, fk=fk, fv=fv, fb=fb, fo=fo, fdo=fdo, flse=flse:
                    fa.fused_attention_bwd_cuda(fq, fk, fv, fb, fo, fdo, flse, scale))
            for n, ad_args in adapter.items():
                fns[f"#2 adapter_fused N={n}"] = lambda ad_args=ad_args: af.adapter_fused_cuda(*ad_args)
            fns.update(head_fns)
            fns["#5 hd80"] = lambda: fa.fused_attention_fwd_cuda(hq, hk, hv, hb, 80 ** -0.5)
            fns["#6 hd80"] = lambda: fa.fused_attention_bwd_cuda(hq, hk, hv, hb, fo80, hdo, flse80,
                                                                 80 ** -0.5)
            fns["#7 hd80"] = lambda: fl.flash_attention_fwd_cuda(hq, hk, hv, None, 80 ** -0.5)
            row = {label: (cs.device_ms(torch, fn), cs.cuda_ms(torch, fn, 30)) for label, fn in fns.items()}
            if name not in times:  # each tree's launches of one #1, flash backward and #6 call
                cs.launch_breakdown(torch, fns["#1 attn_block serving"], f"{name} #1 B={cs.B} S={cs.S}")
                cs.launch_breakdown(torch, fns["#1 attn_block training"], f"{name} #1 B={cs.TB} S={cs.TS}")
                cs.launch_breakdown(torch, lambda: fl.flash_attention_bwd_cuda(q, k, v, None, o, do, lse, scale),
                                    f"{name} flash backward (delta, #8, #9) B={cs.AB} S={cs.VIT_S}")
                cs.launch_breakdown(torch, fns["#6 fused_attention_bwd training"],
                                    f"{name} #6 B={cs.TB} S={cs.TS} (dq with delta, then dk/dv)")
                cs.launch_breakdown(torch, fns[f"#2 adapter_fused N={cs.B * cs.S}"],
                                    f"{name} #2 N={cs.B * cs.S}")
        times.setdefault(name, []).append(row)
        print(f"time {name}: " + ", ".join(f"{label} {dev:.4f} ms device (wall per call {wall:.4f})"
                                           for label, (dev, wall) in row.items()))
    for label in times["this"][0]:
        mine = [r[label][0] for r in times["this"]]
        theirs = [r[label][0] for r in times["other"]]
        print(f"ab {label}: this {mine} other {theirs}; other / this "
              f"{(sum(theirs) / len(theirs)) / (sum(mine) / len(mine)):.2f}x")
    names = {"#1": ("out", "ctx", "lse"), "#1 training": ("out", "ctx", "lse"), "#3": ("dx",),
             "#4": ("dx", "dwda", "dbda", "dwua", "dbua"), "#7-#9": ("o", "dq", "dk", "dv"),
             "#5/#6 training": ("o", "lse", "dq", "dk", "dv"), "#5/#6 serving": ("o", "lse", "dq", "dk", "dv"),
             f"#2 N={cs.B * cs.S}": ("out",), f"#2 N={cs.S}": ("out",),
             "#7-#9 hd80": ("o", "dq", "dk", "dv"), "#7-#9 hd128": ("o", "dq", "dk", "dv"),
             "#5/#6 hd80": ("o", "lse", "dq", "dk", "dv")}
    for key, labels in names.items():
        apart = []
        for label, a, b in zip(labels, outs["this"][key], outs["other"][key]):
            if a.dtype == torch.bfloat16:
                apart.append(f"{label} {cs.own_ulps(torch, a, b):g} own bf16 ulps")
            else:
                apart.append(f"{label} rel norm {cs.rel_norm(a, b):.2e}")
        print(f"ab outputs {key}, this against other: " + ", ".join(apart))
    return 0


if __name__ == "__main__":
    sys.exit(main())
