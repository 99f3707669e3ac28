"""Where ``chip_smoke.py``'s seconds go: run it with every one of its
top-level functions timed (inclusive of what it calls) and torch.profiler's
stop and ``events()`` timed, then print the totals.

    python3 scripts/chip_smoke_timings.py [--seed 0] > chiprun_out/timings.log 2>&1

It needs what ``chip_smoke.py`` needs (one CUDA card, a checkout of the
repo).  Each call longer than 3 s prints a line ``[timed T] name S s`` as it
ends (T: seconds since the start, indented by nesting depth); the summary
after the script's own output lists the 70 largest totals as seconds, calls
and name.  The script's checks and exit code are ``chip_smoke.py``'s.
"""

import collections
import functools
import inspect
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

SKIP = {"check", "bf16_ulp", "counts_text", "main", "reset_counts", "read_counts", "counters",
        "mask_tag", "port_symbol", "device_launches", "graph_mode", "rel_norm", "own_ulps"}


def main(argv=None) -> int:
    import torch.profiler as tp

    t_start = time.perf_counter()
    total = collections.defaultdict(float)
    calls = collections.Counter()
    depth = [0]

    def timed(name, fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            t0 = time.perf_counter()
            depth[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
                dt = time.perf_counter() - t0
                total[name] += dt
                calls[name] += 1
                if dt > 3.0:
                    print(f"[timed {time.perf_counter() - t_start:7.1f}] {'  ' * depth[0]}{name} "
                          f"{dt:.1f} s", flush=True)
        return inner

    for name, fn in list(vars(chip_smoke).items()):
        if inspect.isfunction(fn) and fn.__module__ == "chip_smoke" and name not in SKIP:
            setattr(chip_smoke, name, timed(name, fn))
    for meth in ("events", "__exit__"):
        setattr(tp.profile, meth, timed(f"profiler.{meth}", getattr(tp.profile, meth)))
    rc = 1
    try:
        rc = chip_smoke.main(argv)
    finally:
        print("chip_smoke_timings: inclusive seconds, calls, function")
        for name, t in sorted(total.items(), key=lambda kv: -kv[1])[:70]:
            print(f"  {t:8.1f} {calls[name]:5d}  {name}")
        print(f"chip_smoke_timings: {time.perf_counter() - t_start:.1f} s in all, exit code {rc}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
