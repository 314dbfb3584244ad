"""Device seconds of the kernels that the program launched inside its named ranges.

A program range (a ``record_function``, which ``utils/tracing.py`` opens for
each span) is a host interval of the Chrome trace (category
``user_annotation``) on the thread that ran it. Each kernel launch is a
runtime or driver call on that thread with a ``correlation`` id, which the
kernel it started carries too, so a kernel belongs to a range when its
launch lies inside one of the range's intervals on the same thread, however
late the device runs it. The trace is read as it was written, before
:func:`portbench.devtrace.reduce` deletes it.
"""
from __future__ import annotations

import bisect
import json

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def kernel_seconds(path, names):
    """``{name: seconds}``: for each range name, the summed device seconds
    of the kernels launched inside its intervals (0.0 where none ran)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") in names and "dur" in e:
            spans.setdefault((e["name"], e.get("tid")), []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    for v in spans.values():
        v.sort()
    owner = {}
    for e in events:
        if e.get("cat") not in LAUNCH_CATS or "correlation" not in e.get("args", {}):
            continue
        ts = float(e["ts"])
        for (name, tid), iv in spans.items():
            if tid != e.get("tid"):
                continue
            i = bisect.bisect_right(iv, (ts, float("inf"))) - 1
            if i >= 0 and iv[i][0] <= ts <= iv[i][1]:
                owner.setdefault(e["args"]["correlation"], []).append(name)
    out = {name: 0.0 for name in names}
    for e in events:
        if e.get("cat") == "kernel" and "dur" in e:
            for name in set(owner.get(e.get("args", {}).get("correlation"), ())):
                out[name] += float(e["dur"]) / 1e6
    return out
