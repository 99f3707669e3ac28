"""``chip_smoke.py::profile_events`` reads a finished profile's events as
``prof.events()`` gives them: the same names, device types, times from the
trace's start and user annotations, with the dispatcher's nested records of
one op dropped as ``EventList`` drops them."""

import collections
import sys
import pathlib

import torch
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def _key(e):
    return (e.name, str(e.device_type), round(e.time_range.start, 3), round(e.time_range.end, 3),
            bool(e.is_user_annotation))


def test_profile_events_match_function_events():
    gen = torch.Generator().manual_seed(0)
    model = torch.nn.Sequential(*[torch.nn.Linear(32, 32) for _ in range(6)])
    x = torch.randn(4, 32, generator=gen)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(4):
            with record_function(chip_smoke.DEVICE_MS_MARK):
                pass
            with record_function(f"chip_smoke.call.{i}"):
                model(x).sum().backward()
                z = torch.empty(5).fill_(1.0)
                z.copy_(torch.ones(5))
                torch._foreach_add_([z], [z])
    mine = chip_smoke.profile_events(torch, prof)
    ref = prof.events()
    assert collections.Counter(map(_key, mine)) == collections.Counter(map(_key, ref))
    # the nested records of one op (aten::sum within aten::sum) are gone here too
    assert sum(e.name == "aten::sum" for e in mine) == sum(e.name == "aten::sum" for e in ref)
    launches = [e for e in mine if e.name == "aten::fill_"]
    assert launches and all(e.self_cpu_time_total == e.time_range.elapsed_us() for e in launches)
