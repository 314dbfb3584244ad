"""Host spans and counters of the program, on the device trace's clock.

A span times one piece of host work at case, batch or request level
(never per launch or per slice): its name, its start and end, the span
that caused it (``parent``), the case and the request it belongs to, and
the thread it ran on. A counter is a named integer.

Tracing is on exactly while a ``torch.profiler`` is recording: the
profiler's process-wide flag is read at each span's start and at each
count. While it is off a span stores nothing and still measures its own
duration (``seconds``), which the program's stage timings use. While it is
on, spans and counters go into one in-memory buffer of at most
:data:`CAP` spans (more are counted in ``tracing.dropped``), which a reader
takes with :func:`take` once the work has ended, and each span opened with
:func:`span` is also a ``record_function`` of the same name, which puts it
into the profiler's trace when it runs on the profiling thread.

Spans are timed with ``time.perf_counter_ns()``. :attr:`Taken.offset_ns`,
``time.time_ns() - time.perf_counter_ns()`` taken when the buffer got its
first span, maps them to the clock of the profiler's Chrome trace, in which
an event's ``ts`` (microseconds) plus ``baseTimeNanoseconds`` is the
``time.time_ns()`` of its start: :func:`add_to_chrome_trace` writes them
there, beside the profiler's own events.

Work handed to another thread keeps its place in the tree: the handing
thread takes :func:`context` (its innermost open span and its request) and
the worker passes it as ``within=``, or runs under :func:`bound`.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time
from collections import namedtuple

import torch.autograd.profiler as _profiler

#: most spans the buffer holds between two :func:`take`
CAP = 1 << 16

class Record(namedtuple("Record", "name t0 t1 id parent case request tid thread")):
    """One finished span: times in ``perf_counter_ns``, the thread it started
    on (native id and name)."""

    __slots__ = ()

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9

#: where work handed to another thread belongs: the span that handed it on
#: and the request it serves (each may be None)
Context = namedtuple("Context", "parent request")

#: what :func:`take` returns: the spans, the counters and the offset that
#: maps ``perf_counter_ns`` to the trace's clock (None: nothing recorded)
Taken = namedtuple("Taken", "spans counters offset_ns")

_lock = threading.Lock()
_local = threading.local()
_ids = [0]
_spans: list = []
_counters: dict = {}
_offset = [None]


def _clock_offset() -> int:
    """``time.time_ns() - time.perf_counter_ns()``, read between two
    ``perf_counter_ns`` reads, of the closest pair of five tries: a thread
    switch between two reads would shift every mapped span by its length."""
    best = None
    for _ in range(5):
        p0 = time.perf_counter_ns()
        t = time.time_ns()
        p1 = time.perf_counter_ns()
        if best is None or p1 - p0 < best[0]:
            best = (p1 - p0, t - (p0 + p1) // 2)
    return best[1]


def enabled() -> bool:
    """Whether a profiler is recording, in any thread of the process."""
    return _profiler._is_profiler_enabled


def new_ids(n: int = 1) -> int:
    """The first of ``n`` consecutive fresh ids (spans, cases, requests)."""
    with _lock:
        first = _ids[0] + 1
        _ids[0] += n
    return first


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def context() -> Context:
    """This thread's place: its innermost open span and its request."""
    stack = _stack()
    return Context(stack[-1] if stack else None, getattr(_local, "request", None))


@contextlib.contextmanager
def bound(within: Context):
    """Run the block as if inside ``within``: its spans' parent is
    ``within.parent`` and they carry ``within.request``."""
    saved = _stack(), getattr(_local, "request", None)
    _local.stack = [within.parent] if within.parent is not None else []
    _local.request = within.request
    try:
        yield
    finally:
        _local.stack, _local.request = saved


class Span:
    """A span; use :func:`span` or :func:`begin`. ``seconds`` is its
    duration once ended, ``t0``/``t1`` its ends in ``perf_counter_ns``,
    ``case`` may be set until it ends; ``id`` is None unless tracing was on
    when it started."""

    __slots__ = ("name", "case", "within", "id", "parent", "request",
                 "t0", "t1", "_thread", "_annotation", "_pushed")

    def __init__(self, name, case=None, within=None):
        self.name, self.case, self.within = name, case, within
        self.id = self.parent = self.request = self._annotation = None
        self._pushed = False
        self.t0 = self.t1 = None

    def start(self, annotate=False):
        if _profiler._is_profiler_enabled:  # the one read while tracing is off
            self._open(annotate)
        # after the profiler's event opens, as ``end`` reads before it closes:
        # the span lies inside its event. The profiler's op releases the GIL,
        # so this read may wait out another thread's turn (milliseconds).
        self.t0 = time.perf_counter_ns()
        return self

    def _open(self, annotate):
        if _offset[0] is None:
            with _lock:
                if _offset[0] is None:
                    _offset[0] = _clock_offset()
        self.id = new_ids()
        self._thread = threading.get_native_id(), threading.current_thread().name
        here = self.within or context()
        self.parent, self.request = here.parent, here.request
        if annotate:
            _stack().append(self.id)
            self._pushed = True
            self._annotation = _profiler.record_function(self.name)
            self._annotation.__enter__()

    def end(self):
        """End the span (from any thread, for one made by :func:`begin`)."""
        self.t1 = time.perf_counter_ns()
        if self.id is None:
            return
        if self._pushed:
            stack = _stack()
            if stack and stack[-1] == self.id:
                stack.pop()
            self._annotation.__exit__(None, None, None)
        rec = Record(self.name, self.t0, self.t1, self.id, self.parent, self.case,
                     self.request, *self._thread)
        with _lock:
            if len(_spans) < CAP:
                _spans.append(rec)
            else:
                _counters["tracing.dropped"] = _counters.get("tracing.dropped", 0) + 1

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def __enter__(self):
        return self.start(annotate=True)

    def __exit__(self, *exc):
        self.end()


def span(name, case=None, within=None) -> Span:
    """A span of the ``with`` block, on this thread; also a
    ``record_function`` of the same name while tracing is on."""
    return Span(name, case, within)


def begin(name, case=None, within=None) -> Span:
    """A span started now and ended by ``end()``, on any thread (no
    ``record_function``)."""
    return Span(name, case, within).start()


def traced(name):
    """Decorate a function so that each call is one span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name, n=1):
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if enabled():
        with _lock:
            _counters[name] = _counters.get(name, 0) + int(n)


def take() -> Taken:
    """The buffer's spans and counters, emptied."""
    with _lock:
        out = Taken(list(_spans), dict(_counters), _offset[0])
        _spans.clear()
        _counters.clear()
        _offset[0] = None
    return out


def add_to_chrome_trace(path, taken: Taken):
    """Write ``taken``'s spans into the profiler's Chrome trace at ``path``,
    on the trace's clock: one complete event (category ``program_span``)
    per span on its thread's row, each thread named, and the counters under
    the trace's key ``programCounters``."""
    with open(path) as f:
        trace = json.load(f)
    events = trace.setdefault("traceEvents", [])
    if taken.spans:
        base = int(trace.get("baseTimeNanoseconds", 0))
        pid, names = os.getpid(), {}
        for r in taken.spans:
            names[r.tid] = r.thread
            events.append({
                "ph": "X", "cat": "program_span", "name": r.name, "pid": pid,
                "tid": r.tid, "ts": (r.t0 + taken.offset_ns - base) / 1e3,
                "dur": (r.t1 - r.t0) / 1e3,
                "args": {"id": r.id, "parent": r.parent, "case": r.case,
                         "request": r.request}})
        events.extend({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": name}} for tid, name in names.items())
    trace["programCounters"] = dict(taken.counters)
    with open(path, "w") as f:
        json.dump(trace, f)
