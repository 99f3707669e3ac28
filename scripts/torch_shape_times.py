"""Time the port's kernels at two public encoders' layer geometries, on one
CUDA card, by the profiler's device time.

    python3 scripts/torch_shape_times.py [--seed 0]

The geometries are chip_smoke.py's phase 20 (b): ViT-H/14's layer (Dm 1280,
16 heads of 80, F 5120, adapter bottleneck 80) and DeiT-Ti's (Dm 192, 3 heads
of 64, F 768, bottleneck 12), at B=16 (the serving batch) and S=185 (the
training canvas): #2 at 16 x 185 rows.  For each kernel, ``chip_smoke.time_row``: the
kernel's device time (median of 10 calls), its plain version's, one library
call or chain for the same function (a yardstick the port never calls) and
the least time the card could take (``chip_smoke``'s bound functions at that
width):

* #1 (LN1 fused) against F.layer_norm + F.linear + SDPA + F.linear; #3 and
  #4 (ensemble) against the forward from x and autograd.grad through it;
* #2 against the torch.addmm chain;
* #5/#6 (a [B, 1, 1, S] padding bias) against SDPA and autograd.grad
  through it; #7 (no bias, the ViT's self-attention) against SDPA, #8 and
  #9 against autograd.grad through SDPA (the pair's one call).

ViT-H/14's head dim 80 runs csrc/attn_any.cuh's kernels; DeiT-Ti's width 192
runs gemm_sm90.cuh's tail kernel for #1/#3/#4 and #4's adapter passes at
width 256.  Prints the card's name and power limit first and the launch
breakdown of one #1 call at each geometry.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def time_geometry(torch, cs, label, b, s, r, seed):
    """Every kernel's row at the width chip_smoke.widths set -> {kernel: row}."""
    import torch.nn.functional as F

    from feddat_tpu_torch.ops import flash as fl
    from feddat_tpu_torch.ops import fused_attention as fa

    rows = {"attn_block": cs.time_attn_block(torch, b, s, seed)}
    rows["attn_block_bwd"] = cs.attn_bwd_row(torch, b, s, True, seed)[0]
    rows["layer_block_bwd"] = cs.layer_bwd_row(torch, b, s, True, seed, r=r)[0]
    rows["adapter_fused"] = cs.time_adapter(torch, b * s, seed, r, cs.DM)
    q, k, v, do = cs.fused_inputs(torch, b, s, seed)
    bias = cs.padding_bias(torch, b, s, seed)
    scale = (cs.DM // cs.HEADS) ** -0.5
    with torch.no_grad():
        o, lse = fa.fused_attention_fwd_cuda(q, k, v, bias, scale)
    rows["fused_attention"] = cs.time_row(
        torch, f"{label} fused_attention B={b} S={s}", lambda: fa.fused_attention_fwd_cuda(q, k, v, bias, scale),
        lambda: fa.fused_attention_fwd_ref(q, k, v, bias, scale),
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias.bfloat16(), scale=scale),
        cs.fused_attention_bound(b, s, False), "SDPA with the mask")
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, attn_mask=bias.bfloat16(), scale=scale)
    rows["fused_attention_bwd"] = cs.time_row(
        torch, f"{label} fused_attention_bwd B={b} S={s}",
        lambda: fa.fused_attention_bwd_cuda(q, k, v, bias, o, do, lse, scale),
        lambda: fa.fused_attention_bwd_ref(q, k, v, bias, o, do, lse, scale),
        lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
        cs.fused_attention_bound(b, s, True), "autograd.grad through SDPA")
    with torch.no_grad():
        fo, flse = fl.flash_attention_fwd_cuda(q, k, v, None, scale)
        run_dq, run_dkv, _ = fl.flash_bwd_launchers(q, k, v, None, fo, do, flse, scale)
    rows["flash_attention"] = cs.time_row(
        torch, f"{label} flash_attention B={b} S={s} no bias", lambda: fl.flash_attention_fwd_cuda(q, k, v, None, scale),
        lambda: fl.flash_attention_fwd_ref(q, k, v, None, scale),
        lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), cs.flash_bound(b, s, s, 0), "SDPA")
    plain_bwd = lambda: fl.flash_attention_bwd_ref(q, k, v, None, fo, do, flse, scale)  # noqa: E731
    fout = F.scaled_dot_product_attention(*leaves, scale=scale)
    sdpa_bwd = lambda: torch.autograd.grad(fout, leaves, do, retain_graph=True)  # noqa: E731
    rows["flash_attention_bwd_dq"] = cs.time_row(
        torch, f"{label} flash_attention_bwd_dq B={b} S={s}", run_dq, plain_bwd, sdpa_bwd,
        cs.flash_bwd_bound(b, s, s, 0, "dq"), "autograd.grad through SDPA (dq, dk and dv)")
    rows["flash_attention_bwd_dkv"] = cs.time_row(
        torch, f"{label} flash_attention_bwd_dkv B={b} S={s}", run_dkv, plain_bwd, sdpa_bwd,
        cs.flash_bwd_bound(b, s, s, 0, "dkv"), "autograd.grad through SDPA (dq, dk and dv)")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_shape_times: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from feddat_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    _build.build()
    b, s = cs.B, cs.TS  # the serving batch at the training canvas
    for label, dm, heads, ff, rf in cs.SHAPE_GEOMETRIES:
        with cs.widths(dm, heads, ff):
            rows = time_geometry(torch, cs, label, b, s, dm // rf, args.seed)
        for name, (k_ms, p_ms, l_ms, bound, bound_by, _) in rows.items():
            print(f"shape_times {label} (Dm {dm}, {heads} heads of {dm // heads}, F {ff}, R {dm // rf}) "
                  f"B={b} S={s} {name}: {k_ms:.4f} ms device, bound {bound:.4f} ms by {bound_by} "
                  f"({100 * bound / k_ms:.1f}% of bound), plain {p_ms:.4f} ms, library {l_ms:.4f} ms "
                  f"(kernel / library {k_ms / l_ms:.2f}x)")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
