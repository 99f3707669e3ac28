"""Where one CTA of the ensemble-adapter kernel (#2) spends its cycles, on
one CUDA card.

    python3 scripts/adapter_phase_stamps.py [--out logs/var/stamps]

The profiler sees a kernel as one span.  This script copies
``feddat_tpu_torch/csrc`` to ``--out``, inserts ``clock64()`` stamps at the
phase boundaries of ``adapter_fused.cu`` (thread 0 of CTAs 0, 3, 4 and the
last one writes them to a ``__device__`` array that an extra C entry point
reads back), builds the copy with the package's nvcc flags, runs it at the
serving batch (N = 16 * 281 rows) and the B=1 bucket (N = 281), R = 48 (one
chunk of the bottleneck, so no scratch), and
prints each CTA's cycles since its start at every stamp:

    issue   the biases staged and the first two k-tiles' copies issued
    gemm1   the down projection's partial done (all k-tiles)
    sync1   the partial written, the cluster barrier passed
    rows    this rank's rows summed, split and written
    parts   the other ranks' rows received
    ch0-2   each 64-column chunk of the up projection and its epilogue issued
    end     the kernel's last instruction

The committed source is untouched.  An anchor that no longer matches the
source stops the script with the anchor's text.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# (phase, source line the stamp goes after (+) or before (-))
ANCHORS = (
    ("start", "+", "  const int k0 = rank * L.KS;  // this rank's K slice of GEMM1 and its output columns of GEMM2\n"),
    ("issue", "+", "    for (int j = 0; j < BD_PER; ++j) bd_s[tid + j * AD_THREADS] = bdv[j];\n"),
    ("gemm1", "-", "    // The partial in region B"),
    ("sync1", "+", "    cluster_sync();  // every rank's partial is written\n"),
    ("rows", "-", "    asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: \"memory\");  // the parts, visible"),
    ("parts", "+", "    wait_phase(bar_parts, c & 1);\n"),
    ("ch", "+", "      stage_wu(ch + 2);\n"),
    ("end", "-", "  // the copies to the other ranks have read this rank's tiles"),
)
PHASES = ("start", "issue", "gemm1", "sync1", "rows", "parts", "ch0", "ch1", "ch2", "end")
CTAS = 4


def stamped_copy(out: Path) -> Path:
    """``out``/feddat_tpu_torch/csrc with the stamps in adapter_fused.cu."""
    csrc = out / "feddat_tpu_torch" / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(REPO / "feddat_tpu_torch" / "csrc", csrc)
    src = csrc / "adapter_fused.cu"
    s = src.read_text()
    for phase, where, anchor in ANCHORS:
        if s.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in adapter_fused.cu: {anchor!r}")
        if phase == "ch":
            stamp = f"    STAMP({PHASES.index('ch0')} + (ch < 2 ? ch : 2));\n"
        else:
            stamp = f"  STAMP({PHASES.index(phase)});\n"
        s = s.replace(anchor, anchor + stamp if where == "+" else stamp + anchor)
    s = s.replace("namespace {\n", f"""__device__ long long ad_stamps[{CTAS}][{len(PHASES)}];
#define STAMP(k) do {{ if (threadIdx.x == 0) {{ \\
    const int w = blockIdx.x == 0 ? 0 : blockIdx.x == 3 ? 1 : blockIdx.x == 4 ? 2 : \\
                  blockIdx.x == gridDim.x - 1 ? 3 : -1; \\
    if (w >= 0) ad_stamps[w][k] = clock64(); }} }} while (0)
namespace {{
""", 1)
    s = s.replace('extern "C" {\n', 'extern "C" {\nint read_stamps(long long* out) {\n'
                  '  return (int)cudaMemcpyFromSymbol(out, ad_stamps, sizeof(ad_stamps));\n}\n', 1)
    src.write_text(s)
    return src


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=REPO / "logs" / "var" / "stamps")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("adapter_phase_stamps: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from feddat_tpu_torch.ops import _build
    from feddat_tpu_torch.ops import adapter_fused as af

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    src = stamped_copy(args.out)
    lib_path = args.out / "libadapter_stamps.so"
    build = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                           capture_output=True, text=True)
    if build.returncode != 0:
        print(build.stdout + build.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.adapter_fused_fwd
    fn.argtypes, fn.restype = af.KERNEL.argtypes, ctypes.c_int
    for n in (cs.B * cs.S, cs.S):
        h, pa, pb, w = cs.adapter_inputs(torch, n, args.seed)
        out = torch.empty_like(h)
        for _ in range(3):  # the last call's stamps are read
            err = fn(h.data_ptr(), *(t.data_ptr() for t in pa), *(t.data_ptr() for t in pb), out.data_ptr(),
                     None, n, cs.DM, cs.R, 0, w, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"adapter_fused_fwd failed: CUDA error {err}")
        torch.cuda.synchronize()
        stamps = (ctypes.c_longlong * (CTAS * len(PHASES)))()
        lib.read_stamps(stamps)
        for c, cta in enumerate(("0", "3", "4", "last")):
            row = [stamps[c * len(PHASES) + k] for k in range(len(PHASES))]
            print(f"stamps N={n} CTA {cta}: " + " ".join(f"{p} {row[k] - row[0]}" for k, p in enumerate(PHASES)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
