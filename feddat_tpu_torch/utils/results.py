"""Result aggregation utilities (copy of ``feddat_tpu/utils/results.py``).

The reference's results tabulator (``src/utils/make_table.py:11-70``, CLiMB
legacy): merge per-run history JSONs into mean±std tables per task.  The
history files of both packages' CLIs have one format, so either reads both.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Sequence


def load_histories(paths: Sequence[str]) -> List[List[dict]]:
    out = []
    for p in paths:
        with open(p) as f:
            out.append(json.load(f))
    return out


def final_scores(history: List[dict]) -> Dict[str, float]:
    """Last-eval primary score per task (DAT evals use the ensemble entry)."""
    if not history:
        return {}
    scores = history[-1]["scores"]
    out = {}
    for task, s in scores.items():
        out[task] = float(s[0] if isinstance(s, (list, tuple)) else s)
    return out


def mean_std_table(histories: Sequence[List[dict]]) -> Dict[str, Dict[str, float]]:
    """Across runs (seeds): {task: {mean, std, n}} + an 'average' row."""
    import numpy as np

    per_task = defaultdict(list)
    for h in histories:
        for task, v in final_scores(h).items():
            per_task[task].append(v)
    table = {
        task: {
            "mean": float(np.mean(v)),
            "std": float(np.std(v)),
            "n": len(v),
        }
        for task, v in per_task.items()
    }
    if table:
        means = [row["mean"] for row in table.values()]
        table["average"] = {
            "mean": float(np.mean(means)),
            "std": float(np.std(means)),
            "n": len(means),
        }
    return table


def format_table(table: Dict[str, Dict[str, float]]) -> str:
    lines = [f"{'task':<24} {'mean':>8} {'std':>8} {'runs':>5}"]
    for task, row in table.items():
        lines.append(f"{task:<24} {row['mean']:>8.2f} {row['std']:>8.2f} {row['n']:>5}")
    return "\n".join(lines)


def main(argv=None) -> int:
    """``python -m feddat_tpu_torch.utils.results run1.history.json run2...`` —
    the reference's standalone tabulator (``make_table.py``) as a command:
    merge per-seed history JSONs into one mean±std table."""
    import argparse

    p = argparse.ArgumentParser("feddat_tpu_torch.results")
    p.add_argument("histories", nargs="+", help="*.history.json files (one per run/seed)")
    args = p.parse_args(argv)
    print(format_table(mean_std_table(load_histories(args.histories))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
