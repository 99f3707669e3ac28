#!/usr/bin/env python
"""Probes of the accuracy study on the port: runs of
``feddat_tpu_torch/study.py::run_study`` per attention route, mode and seed,
the same clients and initial weights on every route, so the scores differ
only by the route's arithmetic (or by the BERT dropout, where it is set).

    python scripts/torch_study_routes.py [--family vilt|albef] [--routes block,layer,auto]
        [--modes dat] [--seeds 0] [--bert_dropout RATE] [--out DIR] [--device cuda|cpu]

``block`` is #1 forward and #3 backward, ``layer`` #1 and the whole-layer
backward #4, ``auto`` the plain route (no kernel): the port's own yardstick
on the card.  ``--bert_dropout`` sets both dropout rates of ALBEF's BERT
towers (the study's config keeps 0.1).  Prints, per route, mode and seed,
each client's final scores (DAT: ensemble, local ``adapter_0``, shared
``adapter_1``), the average of each and the run's wall seconds, then one
JSON line of the same.  ``--out`` keeps each run's history as
``DIR/<route>/[albef_]<mode>_seed<seed>.history.json``
(``scripts/torch_accuracy_study.py --histories DIR/<route>`` tabulates them).
"""

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser("torch_study_routes")
    p.add_argument("--family", default="vilt", choices=["vilt", "albef"])
    p.add_argument("--routes", default="block,layer,auto")
    p.add_argument("--modes", default="dat")
    p.add_argument("--seeds", default="0")
    p.add_argument("--bert_dropout", type=float, default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    import torch

    from feddat_tpu_torch import study

    if args.bert_dropout is not None:
        if args.family != "albef":
            p.error("--bert_dropout applies to the ALBEF family")
        build = study._study_albef_model

        def without_dropout(mode, full_scale, attn_impl=None):
            model, cfg = build(mode, full_scale, attn_impl)
            bert = dataclasses.replace(cfg.bert, hidden_dropout=args.bert_dropout,
                                       attention_dropout=args.bert_dropout)
            cfg = dataclasses.replace(cfg, bert=bert)
            with torch.device("meta"):
                return type(model)(cfg, dtype=model.dtype,
                                   vision_attn_impl=model.visual_encoder.attn_impl), cfg

        study._study_albef_model = without_dropout

    out = {}
    for route in [r.strip() for r in args.routes.split(",") if r.strip()]:
        for mode in [m.strip() for m in args.modes.split(",") if m.strip()]:
            for seed in [int(s) for s in args.seeds.split(",")]:
                t0 = time.perf_counter()
                res = study.run_study(modes=(mode,), seeds=(seed,), family=args.family,
                                      attn_impl=route, device=args.device,
                                      out_dir=os.path.join(args.out, route) if args.out else None)
                wall = time.perf_counter() - t0
                (history,) = res[mode]["histories"]
                scores = {k: s if isinstance(s, list) else [s]
                          for k, s in history[-1]["scores"].items()}
                means = [sum(s[i] for s in scores.values()) / len(scores)
                         for i in range(len(next(iter(scores.values()))))]
                print(f"route {route} {mode} seed {seed}: " + "; ".join(
                    f"{k} {' / '.join(f'{v:.1f}' for v in s)}" for k, s in scores.items())
                    + f"; average {' / '.join(f'{m:.2f}' for m in means)}; {wall:.1f} s",
                    flush=True)
                out[f"{route} {mode} {seed}"] = {"scores": scores, "average": means,
                                                 "wall_s": wall}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
