"""#2's (csrc/adapter_fused.cu) error against the exact function, for the
committed design and for the accumulation orders it was chosen over, on one
CUDA card.

    python3 scripts/adapter_precision.py [--out logs/var/adapter_precision]

Copies ``feddat_tpu_torch/csrc`` once per design, edits the copy of
``adapter_fused.cu`` by exact string replacement (a replacement that does not
match once stops the script), builds every copy with the package's nvcc flags
at once and calls each through ctypes with the wrapper's argument types:

    committed      each chunk of the bottleneck starts its up projection from
                   a fresh accumulator, takes the ReLU output's bf16 parts lo,
                   mid, hi, and adds the chunks' carried sums in one fp32 add
    hi_first       the same with the parts taken hi, mid, lo
    carry_in_acc   the carried sums loaded into the tensor cores' accumulator
    first_chunked  both: the first chunked design

At the serving batch (N = 16 * 281 rows) for R = 48, 128, 192, 196 and 384 at
D = 768 and for R = 80 at D = 1280 and R = 128 at D = 2048 (inputs of
``chip_smoke.adapter_inputs``), each design's output is held against the
plain fp32 version (``adapter_fused_reference``, the comparison of
``chip_smoke.adapter_parity``) and against the same function in fp64 rounded
to bf16, under chip_smoke's limit 2^-7 |ref| + 1e-6: the elements beyond it,
the largest |err| / limit, the largest |err| from fp64 where |ref| < 1e-4 (the
fp32 sums' own error, which the limit's 1e-6 floor must cover), and the
CUDA-event ms per call.  Prints the card's name and power limit first.  The
committed source is untouched.
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

FRESH = """        ya[i] = 0.f;
        yb[i] = 0.f;"""
LOADED = """        ya[i] = c > 0 ? saved[i * AD_THREADS] : 0.f;
        yb[i] = c > 0 ? saved[(32 + i) * AD_THREADS] : 0.f;"""
CARRY_ADD = """      if (c > 0) {  // the chunks before, then this one, each sum rounded once
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          ya[i] = __fadd_rn(saved[i * AD_THREADS], ya[i]);
          yb[i] = __fadd_rn(saved[(32 + i) * AD_THREADS], yb[i]);
        }
      }
"""
LO_FIRST = "      for (int s = 2; s >= 0; --s)  // lo, then mid, then hi: the small parts first\n"
HI_FIRST = "      for (int s = 0; s < 3; ++s)  // hi, then mid, then lo\n"
CARRY = [(FRESH, LOADED), (CARRY_ADD, "")]
DESIGNS = {"committed": [], "hi_first": [(LO_FIRST, HI_FIRST)], "carry_in_acc": CARRY,
           "first_chunked": CARRY + [(LO_FIRST, HI_FIRST)]}
# (N, R, D, seed): chip_smoke's parity seeds at the serving batch
CASES = [(4496, 48, 768, 0), (4496, 128, 768, 7), (4496, 192, 768, 4496 + 192 + 768),
         (4496, 196, 768, 4496 + 196 + 768), (4496, 384, 768, 4496 + 384 + 768), (4496, 384, 768, 11),
         (4496, 80, 1280, 4496 + 80 + 1280), (4496, 128, 2048, 4496 + 128 + 2048)]


def edited_copy(out: Path, name: str, edits) -> Path:
    csrc = out / name
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(REPO / "feddat_tpu_torch" / "csrc", csrc)
    src = csrc / "adapter_fused.cu"
    s = src.read_text()
    for old, new in edits:
        if s.count(old) != 1:
            raise SystemExit(f"{name}: text not found once in adapter_fused.cu: {old[:60]!r}")
        s = s.replace(old, new)
    src.write_text(s)
    return src


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=REPO / "logs" / "var" / "adapter_precision")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("adapter_precision: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from feddat_tpu_torch.ops import _build
    from feddat_tpu_torch.ops import adapter_fused as af

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    procs = {}
    for name, edits in DESIGNS.items():
        src = edited_copy(args.out, name, edits)
        lib = src.with_name("libadapter_design.so")
        procs[name] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    designs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"{name}: nvcc failed\n{log}", file=sys.stderr)
            return 1
        print(f"build {name}: " + " | ".join(_build.ptxas_summary(log)))
        dll = ctypes.CDLL(str(lib))
        fn, ws = dll.adapter_fused_fwd, dll.adapter_fused_workspace
        fn.argtypes, fn.restype = af.KERNEL.argtypes, ctypes.c_int
        ws.argtypes, ws.restype = [ctypes.c_int] * 4, ctypes.c_longlong
        designs[name] = (fn, ws)

    for n, r, d, seed in CASES:
        h, pa, pb, w = cs.adapter_inputs(torch, n, seed, r, d)
        with torch.inference_mode():
            hd = h.double()

            def branch(wd, bd, wu, bu):
                f = [t.double() for t in (wd, bd, wu, bu)]
                return torch.relu(hd @ f[0] + f[1]) @ f[2] + f[3]

            exact = w * branch(*pa) + (1.0 - w) * branch(*pb)
            exact_bf16 = exact.to(torch.bfloat16).double()
            plain = af.adapter_fused_reference(h, pa, pb, w).double()
        near0 = exact.abs() < 1e-4

        def beyond(x, ref):
            lim = 2.0 ** -7 * ref.abs() + 1e-6
            err = (x - ref).abs() / lim
            return int((err > 1).sum()), float(err.max())

        p_fp64 = beyond(plain, exact_bf16)
        print(f"N={n} R={r} D={d} seed={seed}: plain fp32 version against fp64: {p_fp64[0]} beyond the "
              f"limit (largest {p_fp64[1]:.3f} of it)")
        for name, (fn, wsf) in designs.items():
            out = torch.empty_like(h)
            size = wsf(n, d, r, 0)
            ws = torch.empty(size, dtype=torch.uint8, device="cuda") if size else None
            call = (h.data_ptr(), *(t.data_ptr() for t in pa), *(t.data_ptr() for t in pb), out.data_ptr(),
                    None if ws is None else ws.data_ptr(), n, d, r, 0, w,
                    torch.cuda.current_stream().cuda_stream)
            if fn(*call):
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            k = out.double()
            for _ in range(3):
                fn(*call)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                fn(*call)
            end.record()
            torch.cuda.synchronize()
            vs_plain, vs_exact = beyond(k, plain), beyond(k, exact_bf16)
            print(f"  {name:13s}: against the plain version {vs_plain[0]} beyond ({vs_plain[1]:.3f}); against "
                  f"fp64 {vs_exact[0]} beyond ({vs_exact[1]:.3f}); largest |err| from fp64 where |ref| < 1e-4 "
                  f"{float((k - exact).abs()[near0].max()):.3e}; {start.elapsed_time(end) / 20:.4f} ms per call")
    return 0


if __name__ == "__main__":
    sys.exit(main())
