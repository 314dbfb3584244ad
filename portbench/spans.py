"""The program's own spans and counters of a traced window.

The program (``segmentation3d_tpu_torch.utils.tracing``) records host spans
and counters while a profiler records, which in a run of this benchmark is
the traced window alone. :func:`taken` takes the program's buffer once,
after the driver returned, and keeps it on the run for every reader. A
program without that module leaves None there, and each reader here then
returns None. Times in seconds.
"""
from __future__ import annotations

import statistics

KEY = "program_spans"


def taken(run):
    """The program's buffer (spans, counters), taken on the first call."""
    if KEY not in run:
        try:
            from segmentation3d_tpu_torch.utils import tracing
        except ImportError:
            run[KEY] = None
        else:
            run[KEY] = tracing.take()
    return run[KEY]


def spans(run, *names):
    """The spans named ``names``."""
    t = taken(run)
    return [s for s in t.spans if s.name in names] if t is not None else []


def median_per(run, name, key):
    """The median over each value of ``key`` (``case``, ``request``, ``id``)
    of its spans ``name``'s summed seconds."""
    sums = {}
    for s in spans(run, name):
        k = getattr(s, key)
        if k is not None:
            sums[k] = sums.get(k, 0.0) + s.seconds
    return statistics.median(sums.values()) if sums else None


def share(run, names, of):
    """Percent of the seconds of the spans ``of`` spent in spans ``names``."""
    whole = sum(s.seconds for s in spans(run, of))
    if not whole:
        return None
    return 100.0 * sum(s.seconds for s in spans(run, *names)) / whole


def per_span(run, counter, name):
    """The counter ``counter`` (0 if never counted) per span ``name``."""
    t, n = taken(run), len(spans(run, name))
    if t is None or not n:
        return None
    return t.counters.get(counter, 0) / n
