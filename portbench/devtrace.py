"""The device trace of a window, reduced to what the metrics read.

:func:`profiled` runs a block under ``torch.profiler`` (CPU and CUDA
activities) inside a ``portbench.window`` span and writes the Chrome trace;
:class:`Trace` reads it back: the device intervals (kernels, copies, sets),
their union inside the window (busy seconds), kernel time by name, and the
gaps where the device did nothing, each named by the innermost host
operation that was running at its middle.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os

WINDOW = "portbench.window"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function"}


@contextlib.contextmanager
def profiled(path, enabled=True):
    """Profile the block when ``enabled``; the trace goes to ``path``."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """A Chrome trace of one profiled window. Times in seconds."""

    def __init__(self, path):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        spans = [e for e in events if e.get("cat") == "user_annotation"
                 and e.get("name") == WINDOW and "dur" in e]
        if not spans:
            raise ValueError(f"{path}: no {WINDOW} span")
        w = spans[0]
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.device = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                       for e in events if e.get("cat") in DEVICE_CATS and "dur" in e
                       and float(e["ts"]) < self.t1 and float(e["ts"]) + float(e["dur"]) > self.t0]
        self.host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                           for e in events if e.get("cat") in HOST_CATS and "dur" in e
                           and e.get("name") != WINDOW)
        self.busy = _union((max(a, self.t0), min(b, self.t1)) for a, b, _ in self.device)

    @property
    def window_s(self):
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self):
        return sum(b - a for a, b in self.busy) / 1e6

    def kernels(self, match):
        """Durations in seconds of the device operations whose name
        ``match(name)`` accepts."""
        return [(b - a) / 1e6 for a, b, n in self.device if match(n)]

    def top_ops(self, n=10):
        by = {}
        for a, b, name in self.device:
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return sorted(([k[:120], v] for k, v in by.items()), key=lambda t: -t[1])[:n]

    def _host_at(self, t):
        """The innermost host operation running at ``t``."""
        i = bisect.bisect_right(self.host, (t, float("inf"), ""))
        best = None
        for a, b, name in reversed(self.host[max(0, i - 4000):i]):
            if a <= t <= b and (best is None or b - a < best[1] - best[0]):
                best = (a, b, name)
        return best[2] if best else "idle host"

    def idle_gaps(self, n=10):
        edges = [self.t0] + [x for ab in self.busy for x in ab] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._host_at((a + b) / 2)[:120], (b - a) / 1e6] for a, b in gaps[:n]]


def reduce(path):
    """Read the trace at ``path``, then delete the file."""
    tr = Trace(path)
    os.remove(path)
    return tr
