"""Time the port's flash-attention kernels (#7 forward, #8 dq, #9 dk/dv) of this
checkout against those of another source tree, on one CUDA card, by the
profiler's device time.

    git archive <commit> feddat_tpu_torch/csrc | tar -x -C logs/parent
    python3 scripts/torch_flash_ab.py --other logs/parent

Builds ``feddat_tpu_torch/csrc/flash_attention.cu`` of both trees with the
package's nvcc flags, both at once, then times each tree in the order other,
this, this, other: #7 at ALBEF's ViT site (B=16, H=12, S=577, no bias) and at
its packed decoder site (B=128, Sq=Skv=80, a [128, 1, 80, 80] bias), #8 and
#9 at the ViT site.  Each time is ``chip_smoke.device_ms`` (median over 10
calls of the summed kernel durations) beside the CUDA-event wall per call.
Then SDPA's forward and autograd through SDPA at the ViT shape, the library
yardsticks.  Prints how far the two trees' outputs lie apart, in bf16 ulps of
each element (``chip_smoke.own_ulps``), and the card's name and power limit.
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


def build(trees, out_dir):
    """One nvcc per tree, all started together -> {tree name: library path}."""
    from feddat_tpu_torch.ops import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, procs = _build._nvcc(), {}
    for name, root in trees.items():
        csrc = root / "feddat_tpu_torch" / "csrc"
        lib = out_dir / f"flash_attention_{name}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib), str(csrc / "flash_attention.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} (exit {proc.returncode}):\n{log}")
        regs = [line.strip() for line in log.splitlines() if "registers" in line or "spill" in line]
        print(f"build {name}: {lib.name}; ptxas: " + " | ".join(regs))
        libs[name] = lib
    return libs


def use(lib_path):
    """Route the flash wrappers to the library at ``lib_path``."""
    from feddat_tpu_torch.ops import _build
    from feddat_tpu_torch.ops import flash as fl

    lib = ctypes.CDLL(str(lib_path))
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    _build._LIBS["flash_attention"] = lib
    for kernel in (fl.KERNEL, fl.KERNEL_BWD_DQ, fl.KERNEL_BWD_DKV):
        kernel._fn = None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="root of the other tree (holds feddat_tpu_torch/csrc)")
    ap.add_argument("--build", type=Path, default=REPO / "feddat_tpu_torch" / "_build" / "ab")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_flash_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from feddat_tpu_torch.ops import flash as fl

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    t0 = time.perf_counter()
    libs = build({"other": args.other.resolve(), "this": REPO}, args.build)
    print(f"build: both trees in {time.perf_counter() - t0:.1f} s")

    scale = 64 ** -0.5
    q, k, v, _ = cs.flash_case(torch, cs.AB, cs.VIT_S, cs.VIT_S, "none", args.seed)
    g = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    do = torch.randn(q.shape, generator=g, device="cuda").bfloat16()
    packed = next(c for c in cs.FLASH_CASES if c[0] == "stage-2 packed self")
    qp, kp, vp, biasp = cs.flash_case(torch, *packed[1:], args.seed)

    outs, times = {}, {}
    for name in ("other", "this", "this", "other"):
        use(libs[name])
        with torch.no_grad():
            o, lse = fl.flash_attention_fwd_cuda(q, k, v, None, scale)
            run_dq, run_dkv, grads = fl.flash_bwd_launchers(q, k, v, None, o, do, lse, scale)
            run_dq()
            run_dkv()
            torch.cuda.synchronize()
            outs[name] = (o.clone(), *(t.clone() for t in grads))
            fns = {"#7 vit": lambda: fl.flash_attention_fwd_cuda(q, k, v, None, scale),
                   "#7 packed": lambda: fl.flash_attention_fwd_cuda(qp, kp, vp, biasp, scale),
                   "#8 vit": run_dq, "#9 vit": run_dkv}
            row = {label: (cs.device_ms(torch, fn), cs.cuda_ms(torch, fn, 30)) for label, fn in fns.items()}
        times.setdefault(name, []).append(row)
        print(f"time {name}: " + ", ".join(f"{label} {dev:.4f} ms device (wall per call {wall:.4f})"
                                           for label, (dev, wall) in row.items()))
    for label in times["this"][0]:
        mine = [r[label][0] for r in times["this"]]
        theirs = [r[label][0] for r in times["other"]]
        print(f"ab {label}: this {mine} other {theirs}; other / this "
              f"{(sum(theirs) / len(theirs)) / (sum(mine) / len(mine)):.2f}x")
    apart = [cs.own_ulps(torch, a, b) for a, b in zip(outs["this"], outs["other"])]
    print("ab outputs o, dq, dk, dv: this against other, own bf16 ulps " + ", ".join(f"{u:g}" for u in apart))

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves)
    with torch.no_grad():
        sdpa = cs.device_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v))
    sdpa_bwd = cs.device_ms(torch, lambda: torch.autograd.grad(out, leaves, do, retain_graph=True))
    print(f"library: SDPA forward {sdpa:.4f} ms device, autograd.grad through SDPA (dq, dk, dv) "
          f"{sdpa_bwd:.4f} ms device, B={cs.AB} H={cs.HEADS} S={cs.VIT_S}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
