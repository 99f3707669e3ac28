"""Drive the PyTorch/CUDA port (``feddat_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, in this order:

1. build  — compile every kernel of the serving path from ``feddat_tpu_torch/csrc``
            (one ``nvcc`` per source, all at once) and print the build time.
2. parity — hold each kernel against its plain PyTorch version on the card, at
            the serving shapes and at ragged ones, with the stated tolerances.
3. serve  — full-width ViLT-B/32 DAT in bf16 (attn_impl='block', fused LN, fused
            ensemble adapter, random weights from --seed, a 3129-label VQA head)
            behind ``ViltVqaPredictor.predict``: a batch request and a single one.
            The kernels' launch counts are read around exactly this run, and
            the probabilities are held against the port's plain path
            (attn_impl='auto', unfused adapters) on the same weights.
4. time   — each kernel, its plain version and one PyTorch call chain for the
            same function (a yardstick the port never calls), by CUDA events,
            beside the kernel's bound; forward-only and predict() rates, the
            single-request latency, and a torch.profiler breakdown of one
            forward's device time by kernel.

Prints the card's ``nvidia-smi`` name and power limit, one JSON line with every
kernel's numbers, and as the last line ``{"ok": true, "device": {...}}``.
Exits non-zero, without that line, if there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
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
NUM_LABELS = 3129  # VQAv2 answer vocabulary (feddat_tpu/configs/tasks.py:96)


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def bf16_ulp(v: float) -> float:
    """Spacing of bf16 numbers at magnitude ``v`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(v, 1e-30))) - 7)


def cuda_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call by CUDA events (warm caches, back to back)."""
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


# ----------------------------------------------------------------- inputs
def attn_inputs(torch, b, s, fuse_ln, seed):
    """Attention-block inputs on the card: bf16 activations and weights, fp32
    biases/LN, and a padding bias like the model's (text padding + masked
    image patches at -10000).  The biases are drawn at the scale of the
    projections they are added to, so a dropped or misplaced bias moves the
    outputs far past the tolerances (bk only through lse: the softmax is
    shift-invariant per query)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g, device="cuda") * std).to(dtype)

    x = randn(b, s, DM, dtype=torch.bfloat16)
    ws = [randn(DM, DM, std=0.04, dtype=torch.bfloat16) for _ in range(4)]
    bqkv, bo = randn(3, DM, std=1.0), randn(1, DM, std=1.0)
    gb = torch.stack([1.0 + randn(DM, std=0.1), randn(DM, std=0.1)]) if fuse_ln else None
    valid = torch.randint(max(1, s // 3), s + 1, (b, 1), generator=g, device="cuda")
    keys = torch.arange(s, device="cuda")[None, :]
    bias = ((keys >= valid).float() * -10000.0)[:, None, None, :]
    return (x, *ws, bqkv, bo, gb, bias, HEADS, 64 ** -0.5, 1e-12 if fuse_ln else None)


def adapter_inputs(torch, n, seed):
    """Adapter inputs on the card, all bf16; the biases are drawn at the scale
    of the products they are added to (down ~1.4, up ~0.3), so a dropped
    bias shows."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def p(*shape, std):
        return (torch.randn(*shape, generator=g, device="cuda") * std).to(torch.bfloat16)

    h = p(n, DM, std=1.0)
    pa = (p(DM, R, std=0.05), p(R, std=1.0), p(R, DM, std=0.05), p(DM, std=0.5))
    pb = (p(DM, R, std=0.05), p(R, std=1.0), p(R, DM, std=0.05), p(DM, std=0.5))
    return h, pa, pb, 0.5


# ------------------------------------------------------------------ bounds
def attn_block_bound(b, s, fuse_ln):
    """Least time (ms) for one attention-block call and what bounds it.

    The projections, q.k^T and P.v take bf16 operands (tensor cores); the
    softmax and the LayerNorm are fp32 work on the CUDA cores.  The two pipes
    run at once, so the operations' floor is the larger of their two times."""
    m, d = b * s, DM // HEADS
    bf16_ops = 2 * m * DM * DM * 4 + 2 * 2 * b * HEADS * s * s * d  # 4 projections + QK^T + PV
    fp32_ops = b * HEADS * s * s * 6 + (m * DM * 8 if fuse_ln else 0)  # softmax (+ LN)
    t_ops = max(bf16_ops / PEAK_BF16_FLOPS, fp32_ops / PEAK_FP32_FLOPS)
    nbytes = (3 * m * DM * 2 + 4 * DM * DM * 2 + 4 * DM * 4 + (2 * DM * 4 if fuse_ln else 0)
              + b * s * 4 + b * HEADS * s * 4)  # x, out, ctx; weights; biases; mask; lse
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), bf16_ops


def adapter_bound(n):
    """Least time (ms) for one ensemble-adapter call, what bounds it, and the
    design's own target.

    The down-projections multiply bf16 h by bf16 Wd: the products are exact
    in fp32, so tensor cores with fp32 accumulation do that work at the bf16
    rate.  The up-projections multiply the fp32 ReLU output and are charged,
    with the bias, ReLU and mix, at the fp32 rate; the pipes overlap, so the
    floor is the larger time.  The design target is every operation at the
    fp32 FMA rate, as the kernel does them."""
    mm = n * 2 * 2 * DM * R  # one projection of both adapters
    bf16_ops, fp32_ops = mm, mm + n * (2 * R + 4 * DM)  # + bias+relu, bias+mix
    nbytes = 2 * n * DM * 2 + 2 * (2 * DM * R + R + DM) * 2
    t_ops = max(bf16_ops / PEAK_BF16_FLOPS, fp32_ops / PEAK_FP32_FLOPS)
    t_bytes = nbytes / PEAK_BYTES
    fma_target_ms = 1e3 * (bf16_ops + fp32_ops) / PEAK_FP32_FLOPS
    return (1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"),
            bf16_ops + fp32_ops, fma_target_ms)


# ------------------------------------------------------------------ phases
def phase_build():
    from feddat_tpu_torch.ops import _build

    t0 = time.perf_counter()
    reports = _build.build()
    secs = time.perf_counter() - t0
    print(f"build: {len(reports)} kernel sources compiled in {secs:.1f} s ({', '.join(reports)})")
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")


def attn_parity(torch, b, s, fuse_ln, seed):
    from feddat_tpu_torch.ops import attn_block as ab

    args = attn_inputs(torch, b, s, fuse_ln, seed)
    with torch.inference_mode():
        got = ab.attn_block_cuda(*args)
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
        print(f"parity attn_block B={b} S={s} ln={fuse_ln} {name}: max_abs_err={err:.3e} "
              f"tol={tol:.3e} ({ulps} bf16 ulps at max |ref|={r.abs().max().item():.3e})")
        check(err <= tol, f"attn_block {name} disagrees with the plain version: {err} > {tol}")
        errs[name] = err
    return max(errs.values())


def adapter_parity(torch, n, seed):
    from feddat_tpu_torch.ops import adapter_fused as af

    h, pa, pb, w = adapter_inputs(torch, n, seed)
    with torch.inference_mode():
        got = af.adapter_fused_cuda(h, pa, pb, w).float()
        want = af.adapter_fused_reference(h, pa, pb, w).float()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "adapter_fused has non-finite values")
    err = (got - want).abs()
    # both sides do fp32 math and round once to bf16: they may differ by one
    # bf16 ulp where the fp32 sums land on either side of a rounding point
    bad = (err > 2.0 ** -7 * want.abs() + 1e-6).sum().item()
    print(f"parity adapter_fused N={n}: max_abs_err={err.max().item():.3e} "
          f"elements beyond one bf16 ulp (2^-7 |ref| + 1e-6): {bad}")
    check(bad == 0, f"adapter_fused disagrees with the plain version in {bad} elements")
    return err.max().item()


def phase_parity(torch, seed):
    errs = {"attn_block": attn_parity(torch, B, S, True, seed)}
    for b, s, ln in ((3, 21, True), (3, 17, False), (3, 21, False), (2, 130, True)):
        attn_parity(torch, b, s, ln, seed + s)
    errs["adapter_fused"] = adapter_parity(torch, B * S, seed)
    for n in (3 * 21, 17):
        adapter_parity(torch, n, seed + n)
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


def build_predictor(torch, seed, attn_impl, fused, state=None):
    from feddat_tpu_torch.configs.core import PEFTMode
    from feddat_tpu_torch.data.tokenizer import WordPieceTokenizer
    from feddat_tpu_torch.models import create_model
    from feddat_tpu_torch.models.vilt import TaskHeadSpec
    from feddat_tpu_torch.serving import ViltVqaPredictor

    model, cfg = create_model(
        "vilt", {"vqa": TaskHeadSpec(num_labels=NUM_LABELS)}, PEFTMode.DAT, 16, "bfloat16",
        image_size=CANVAS, attn_impl=attn_impl, adapter_fused=fused, seed=seed,
    )
    check(cfg.fuse_ln and cfg.adapter.fused == fused, f"unexpected model config {cfg}")
    tok = WordPieceTokenizer.from_vocab_file(str(REPO / "tests" / "fixtures" / "vocab30k.txt"))
    return ViltVqaPredictor(
        model, state, "vqa", tok, [f"answer_{i}" for i in range(NUM_LABELS)], batch_size=B,
        canvas=CANVAS, max_text_len=TEXT_LEN, adapter_mode="ensemble", batch_buckets=(1,),
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
    print(f"serve: kernel path vs plain path probabilities max_abs_diff={diff:.3e} tol={tol:.3e} "
          f"(5% of max prob {top:.3e}); top-1 agreement {agree}/{n}")
    check(diff <= tol, f"kernel path disagrees with the plain path: {diff} > {tol}")
    singles = pred.predict(imgs[:1], qs[:1], top_k=5)
    check([a for a, _ in singles[0]] == [a for a, _ in single_out[0]], "single request not stable")
    return pred, plain, launches, (imgs, qs, batch)


def phase_time(torch, pred, plain, requests, seed):
    import torch.nn.functional as F

    from feddat_tpu_torch.ops import adapter_fused as af
    from feddat_tpu_torch.ops import attn_block as ab

    rows = []
    args = attn_inputs(torch, B, S, True, seed)
    x, wq, wk, wv, wo, bqkv, bo, gb, bias = args[:9]

    def attn_library():  # the same function as one PyTorch call chain (yardstick)
        xl = F.layer_norm(x, (DM,), gb[0].bfloat16(), gb[1].bfloat16(), 1e-12)
        def split(t):
            return t.view(B, S, HEADS, 64).transpose(1, 2)
        q, k, v = (split(F.linear(xl, w, bqkv[i].bfloat16())) for i, w in enumerate((wq, wk, wv)))
        ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=bias.bfloat16())
        return F.linear(ctx.transpose(1, 2).reshape(B, S, DM), wo, bo[0].bfloat16())

    with torch.inference_mode():
        k_ms = cuda_ms(torch, lambda: ab.attn_block_cuda(*args), 50)
        p_ms = cuda_ms(torch, lambda: ab.attn_block_reference(*args), 10)
        l_ms = cuda_ms(torch, attn_library, 50)
    bound, bound_by, ops = attn_block_bound(B, S, True)
    rows.append(("attn_block", k_ms, p_ms, l_ms, bound, bound_by, ops))

    h, pa, pb, w = adapter_inputs(torch, B * S, seed)

    def adapter_library():
        hf = h.float()
        fa = [t.float() for t in pa]
        fb = [t.float() for t in pb]
        a = torch.addmm(fa[3], torch.relu(torch.addmm(fa[1], hf, fa[0])), fa[2])
        b = torch.addmm(fb[3], torch.relu(torch.addmm(fb[1], hf, fb[0])), fb[2])
        return (w * a + (1.0 - w) * b).bfloat16()

    with torch.inference_mode():
        k_ms = cuda_ms(torch, lambda: af.adapter_fused_cuda(h, pa, pb, w), 100)
        p_ms = cuda_ms(torch, lambda: af.adapter_fused_reference(h, pa, pb, w), 20)
        l_ms = cuda_ms(torch, adapter_library, 50)
    bound, bound_by, ops, fma_target = adapter_bound(B * S)
    rows.append(("adapter_fused", k_ms, p_ms, l_ms, bound, bound_by, ops))
    for name, k_ms, p_ms, l_ms, bound, bound_by, ops in rows:
        print(f"time {name}: kernel {k_ms:.4f} ms ({ops / k_ms / 1e9:.1f} TFLOP/s), "
              f"bound {bound:.4f} ms by {bound_by} ({100 * bound / k_ms:.1f}% of bound), "
              f"plain {p_ms:.4f} ms, library chain {l_ms:.4f} ms")
    print(f"time adapter_fused: design target, all operations at the fp32 FMA rate, "
          f"{fma_target:.4f} ms ({100 * fma_target / rows[1][1]:.1f}% reached)")

    imgs, qs, batch = requests
    # kernel path vs plain path in alternating pairs (kp, pk, kp, ...), so
    # host-load drift hits both alike; each sample is 10 forwards
    k_samples, p_samples = [], []
    for i in range(10):
        for path in ((pred, plain) if i % 2 == 0 else (plain, pred)):
            ms = cuda_ms(torch, lambda: path.forward(batch), 10, warmup=1)
            (k_samples if path is pred else p_samples).append(ms)
    fwd_ms, plain_fwd_ms = statistics.median(k_samples), statistics.median(p_samples)
    wins = sum(k < p for k, p in zip(k_samples, p_samples))
    print(f"time serve: forward kernel path vs plain path, 10 alternating pairs: medians "
          f"{fwd_ms:.3f} vs {plain_fwd_ms:.3f} ms; kernel path faster in {wins}/10 pairs; "
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
    profile_forward(torch, pred, batch)
    return {name: (k, p, l, bd, by) for name, k, p, l, bd, by, _ in rows}


def profile_forward(torch, pred, batch):
    """Device time of one kernel-path forward by kernel, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    pred.forward(batch)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        pred.forward(batch)
        end.record()
        end.synchronize()
    wall_us = 1e3 * start.elapsed_time(end)
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    if busy == 0:
        print("profile: torch.profiler recorded no device time for the forward")
        return
    groups = {"attn_block": ("gemm_bias_kernel", "attn_kernel"), "adapter_fused": ("adapter_kernel",)}
    shares = {g: sum(t for n, t in by_name.items() if any(k in n for k in keys))
              for g, keys in groups.items()}
    print(f"profile forward (B={B}): wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
          f"(idle {100 * (1 - busy / wall_us):.1f}%), "
          + ", ".join(f"{g} {t / 1e3:.3f} ms ({100 * t / busy:.1f}%)" for g, t in shares.items())
          + f", other {(busy - sum(shares.values())) / 1e3:.3f} ms")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {t / 1e3:8.3f} ms {100 * t / busy:5.1f}%  {name[:110]}")


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

    phase_build()
    errs = phase_parity(torch, args.seed)
    pred, plain, launches, requests = phase_serve(torch, args.seed)
    times = phase_time(torch, pred, plain, requests, args.seed)

    sources = {
        "attn_block": ("feddat_tpu_torch/csrc/attn_block.cu", "feddat_tpu/ops/attn_block.py:90"),
        "adapter_fused": ("feddat_tpu_torch/csrc/adapter_fused.cu",
                          "feddat_tpu/ops/adapter_fused.py:30"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        k_ms, p_ms, l_ms, bound, bound_by = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name], "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": bound, "bound_by": bound_by, "library_ms": l_ms,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
