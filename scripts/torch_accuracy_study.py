#!/usr/bin/env python
"""Run the synthetic heterogeneous-federation accuracy study on the port
(counterpart of ``scripts/accuracy_study.py``; design in
``feddat_tpu_torch/study.py``).

On the CUDA card this runs the real engines at full width (ViLT-B/32 on a
192x192 canvas, or ALBEF with the ViT at S=577) across modes x seeds and
prints the cross-seed mean±std table and one JSON line of the tables;
``--device cpu`` runs tiny shapes on the CPU (the same code path).

    python scripts/torch_accuracy_study.py [--seeds 0,1,2] [--rounds 8]
        [--modes none,adapter,dat] [--family vilt|albef] [--attn_impl block|layer]
        [--out DIR] [--device cuda|cpu] [--smoke]
    python scripts/torch_accuracy_study.py --histories DIR [--modes ...]

After the table, one line per mode gives the per-seed averages over clients
of the final score (DAT: the ensemble score) with their mean and standard
deviation, and for DAT the ensemble, local (``adapter_0``) and shared
(``adapter_1``) scores' mean and standard deviation over client-seed pairs.
``--histories`` prints those lines for the ``*.history.json`` files of an
earlier run (this script's ``--out``, or ``scripts/accuracy_study.py``'s)
and trains nothing.  The run's wall time and device go to standard error.
"""

import argparse
import glob
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def seed_summary(histories_by_mode) -> str:
    """{mode: [history per seed]} -> the per-seed and DAT three-mode lines."""
    import numpy as np

    lines = []
    for mode, histories in histories_by_mode.items():
        finals = [h[-1]["scores"] for h in histories]
        per_seed = np.array([np.mean([s[0] if isinstance(s, list) else s for s in f.values()])
                             for f in finals])
        lines.append(f"{mode}: {len(finals)} seeds, per-seed averages "
                     f"{np.round(per_seed, 2).tolist()}, mean {per_seed.mean():.2f}, "
                     f"sd {per_seed.std():.2f}")
        if mode == "dat":
            pairs = np.array([s for f in finals for s in f.values()])
            m, sd = pairs.mean(0), pairs.std(0)
            lines.append(f"dat three modes over {len(pairs)} client-seed pairs: ensemble "
                         f"{m[0]:.1f} ± {sd[0]:.1f}, local {m[1]:.1f} ± {sd[1]:.1f}, shared "
                         f"{m[2]:.1f} ± {sd[2]:.1f}")
    return "\n".join(lines)


def stored_histories(directory, modes):
    """{mode: [history per seed]} from ``[albef_]<mode>_seed<N>.history.json``."""
    out = {}
    for mode in modes:
        paths = sorted(q for q in glob.glob(os.path.join(directory, f"*{mode}_seed*.history.json"))
                       if re.fullmatch(rf"(albef_)?{mode}_seed\d+\.history\.json",
                                       os.path.basename(q)))
        if paths:
            out[mode] = [json.load(open(q)) for q in paths]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser("torch_accuracy_study")
    p.add_argument("--modes", default="none,adapter,dat")
    p.add_argument("--family", default="vilt", choices=["vilt", "albef"])
    p.add_argument("--seeds", default="0,1,2")
    p.add_argument("--rounds", type=int, default=8)
    p.add_argument("--clients", type=int, default=4)
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--out", default=None, help="directory for per-run history JSONs")
    p.add_argument("--smoke", action="store_true", help="force tiny shapes")
    p.add_argument("--attn_impl", default=None, choices=["block", "layer"],
                   help="full-scale kernel for eligible modes (default block)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the port runs; cuda raises without a card")
    p.add_argument("--histories", default=None,
                   help="summarise this directory's history files instead of training")
    args = p.parse_args(argv)
    modes = [m.strip() for m in args.modes.split(",") if m.strip()]
    if args.histories:
        print(seed_summary(stored_histories(args.histories, modes)))
        return 0

    from feddat_tpu_torch.study import format_study, run_study

    t0 = time.perf_counter()
    results = run_study(
        modes=modes,
        seeds=[int(s) for s in args.seeds.split(",")],
        attn_impl=args.attn_impl,
        num_clients=args.clients,
        comm_rounds=args.rounds,
        full_scale=False if args.smoke else None,
        lr=args.lr,
        out_dir=args.out,
        family=args.family,
        device=args.device,
    )
    print(format_study(results))
    print(seed_summary({m: r["histories"] for m, r in results.items()}))
    print(json.dumps({m: r["table"] for m, r in results.items()}))
    import torch

    where = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    print(f"torch_accuracy_study: {time.perf_counter() - t0:.1f} s on {where}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
