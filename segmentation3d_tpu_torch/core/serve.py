"""Warm-session segmentation server (the ``seg_serve`` CLI).

The port's own copy of ``segmentation3d_tpu/core/serve.py`` (transport
only). One process stays alive with :mod:`.seg_infer`'s session cache warm
(models loaded, forwards built, int8 calibration done) and serves
segmentation requests over a newline-delimited-JSON protocol on a
Unix-domain or TCP socket, so a request after the first pays no model load,
forward build or calibration.

Protocol — one JSON object per line, one JSON response line each:

    {"input": <image|list.txt|csv|folder>, "output_dir": <dir>
     [, "seg_name": "seg.mha", "save_image": false, "save_prob": false]}
        -> {"ok": true, "results": [[case, secs], ...], "secs": total}
    {"cmd": "ping"}      -> {"ok": true, "pong": true, "model_dir": ...,
                             "served": N, "uptime_s": ...}
    {"cmd": "shutdown"}  -> {"ok": true, "shutdown": true}   (server exits)

Engine options (model, partitioning, dtype, quant, TTA) are fixed at
server start, so every request after the first reuses the session;
per-request fields are limited to input/output naming.

Execution model: segmentation requests run single-flight on the device in
strict FIFO arrival order, but the server is a two-stage pipeline: while
request N computes, request N+1's host work (case discovery, file read,
decode, upload to the device on the read-ahead's own CUDA stream) already
runs through ``seg_infer.prepare_cases``, so a burst of requests costs
about max(host, device) each instead of their sum. At most one request is
prepared ahead of the one executing, which bounds device memory to one
request's uploaded volumes beside the running one. ``ping`` is answered
at once (health checks must not wait behind a long segmentation);
``shutdown`` queues FIFO, so requests sent before it still run.

Each segmentation request gets an id when the reader thread receives it.
Its :mod:`..utils.tracing` spans carry it on every thread, those of the
read-ahead that ``prep_fn`` starts too: ``serve.pending`` (receipt to the
start of its execution) and ``serve.exec`` (:meth:`SegmentationServer.run`,
with the case loop inside); the response's ``secs`` is the ``serve.exec``
span's.
"""
from __future__ import annotations

import inspect
import json
import os
import queue as _queue
import socket
import threading
import time

from segmentation3d_tpu_torch.utils import tracing

# per-request fields accepted by a segmentation request; anything else is
# rejected loudly (engine options cannot change per request: they would
# rebuild the session, which is what serving exists to avoid)
_REQUEST_KEYS = {"input", "output_dir", "seg_name", "save_image",
                 "save_prob", "cmd"}


class SegmentationServer:
    """Request handler around a fixed segmentation pipeline.

    ``run_fn(input_path, output_dir, seg_name, save_image, save_prob)``
    performs one batch of cases and returns ``[(case_name, secs, ...), ...]``
    — built by the CLI as a closure over ``core.seg_infer.segmentation`` (or
    the coarse-to-fine entry point), so this class stays transport-only. A
    ``run_fn`` that also accepts ``prepared=`` receives the pre-started
    read-ahead built by ``prep_fn`` (see :func:`serve_forever`).
    """

    def __init__(self, run_fn, model_dir: str, seg_name: str = "seg.mha"):
        self.run_fn = run_fn
        self.model_dir = model_dir
        self.seg_name = seg_name
        self.served = 0
        self._t0 = time.time()
        try:
            self._takes_prepared = "prepared" in \
                inspect.signature(run_fn).parameters
        except (TypeError, ValueError):
            self._takes_prepared = False

    def validate(self, req: dict):
        """Raise on a malformed request; returns the ``cmd`` (or None)."""
        if not isinstance(req, dict):
            raise ValueError("request must be a JSON object")
        unknown = set(req) - _REQUEST_KEYS
        if unknown:
            raise ValueError(
                f"unknown request field(s) {sorted(unknown)}; engine "
                "options are fixed at server start (restart seg_serve "
                "to change them)")
        cmd = req.get("cmd")
        if cmd not in (None, "ping", "shutdown"):
            raise ValueError(f"unknown cmd {cmd!r}")
        if cmd is None and ("input" not in req or "output_dir" not in req):
            raise ValueError("request needs 'input' and 'output_dir'")
        return cmd

    def ping_response(self) -> dict:
        return {"ok": True, "pong": True, "model_dir": self.model_dir,
                "served": self.served,
                "uptime_s": round(time.time() - self._t0, 1)}

    def run(self, req: dict, prepared=None) -> dict:
        """Execute one (already-validated) segmentation request; its
        ``secs`` are the ``serve.exec`` span's."""
        try:
            kw = {}
            if self._takes_prepared:
                kw["prepared"] = prepared
            with tracing.span("serve.exec") as span:
                results = self.run_fn(
                    str(req["input"]), str(req["output_dir"]),
                    str(req.get("seg_name", self.seg_name)),
                    bool(req.get("save_image", False)),
                    bool(req.get("save_prob", False)), **kw)
            self.served += len(results)
            return {"ok": True,
                    "results": [[r[0], round(float(r[1]), 3)] for r in results],
                    "secs": round(span.seconds, 3)}
        except Exception as e:  # per-request isolation: the server survives
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}

    def handle(self, req: dict) -> tuple[dict, bool]:
        """One request inline -> (response, keep_running). The synchronous
        path (no pipelining), for callers that do their own transport."""
        try:
            cmd = self.validate(req)
        except Exception as e:
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}, True
        if cmd == "ping":
            return self.ping_response(), True
        if cmd == "shutdown":
            return {"ok": True, "shutdown": True}, False
        return self.run(req), True


def _probe_alive(socket_path: str) -> bool:
    """True if a server is currently accepting on ``socket_path``."""
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.settimeout(1.0)
    try:
        c.connect(socket_path)
        return True
    except OSError:
        return False
    finally:
        c.close()


def _bind(socket_path: str | None, host: str | None, port: int | None):
    # listen() right after bind(): the unix socket FILE appears at bind
    # time, and a client that connects in a bind->listen window gets
    # ECONNREFUSED
    if socket_path is not None:
        if os.path.exists(socket_path):
            # only remove a STALE socket (dead server); a live server must
            # not have its address silently stolen by a second instance
            if _probe_alive(socket_path):
                raise OSError(
                    f"a seg_serve server is already listening on "
                    f"{socket_path}; shut it down first or choose another "
                    "--socket path")
            os.unlink(socket_path)
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        srv.bind(socket_path)
        srv.listen(16)
        return srv, socket_path
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host or "127.0.0.1", port or 0))
    srv.listen(16)
    return srv, srv.getsockname()


class _Job:
    """One queued request: the parsed dict + a thread-safe responder bound
    to its connection (reader and executor threads share the socket). A
    segmentation request's span ``serve.pending`` starts at receipt;
    ``within`` carries its id to its later spans."""

    def __init__(self, req, respond, kind):
        self.req = req
        self.respond = respond  # fn(dict) -> None; never raises
        self.kind = kind        # "run" | "shutdown"
        self.prepared = None
        self.prep_error = None
        self.done = threading.Event()
        self.pending = self.within = None
        if kind == "run":
            self.within = tracing.Context(None, tracing.new_ids())
            self.pending = tracing.begin("serve.pending", within=self.within)


def _reader(conn, server, jobs, idle_timeout, max_request_bytes, log,
            stop_evt):
    """Per-connection reader: parses request lines, answers pings/protocol
    errors immediately, enqueues segmentation/shutdown jobs FIFO."""
    lock = threading.Lock()
    with conn:
        conn.settimeout(idle_timeout if idle_timeout and idle_timeout > 0
                        else None)
        rf = conn.makefile("rb")
        wf = conn.makefile("w", encoding="utf-8")

        def respond(resp):
            try:
                with lock:
                    wf.write(json.dumps(resp) + "\n")
                    wf.flush()
            except OSError:
                pass  # client went away; results are on disk regardless

        pending = []  # this connection's queued jobs (to await before EOF)
        while not stop_evt.is_set():
            try:
                # +2: the cap must admit a payload of EXACTLY
                # max_request_bytes plus its newline
                raw = rf.readline(max_request_bytes + 2)
            except (TimeoutError, socket.timeout):
                if any(not j.done.is_set() for j in pending):
                    continue  # awaiting a queued response, not wedged
                if log:
                    log("seg_serve: dropping idle connection "
                        f"(no request within {idle_timeout}s)")
                break
            except OSError:
                break
            if not raw:
                break  # client closed its sending side
            if len(raw.rstrip(b"\n")) > max_request_bytes:
                respond({"ok": False, "error":
                         f"request exceeds {max_request_bytes} bytes"})
                break  # the rest of the oversized line is unread: drop
            line = raw.decode("utf-8", errors="replace").strip()
            if not line:
                continue
            try:
                req = json.loads(line)
            except json.JSONDecodeError as e:
                respond({"ok": False, "error": f"bad JSON: {e}"})
                continue
            try:
                cmd = server.validate(req)
            except Exception as e:
                respond({"ok": False, "error": f"{type(e).__name__}: {e}"})
                continue
            if cmd == "ping":
                # at once: health checks must not wait behind a running
                # segmentation
                respond(server.ping_response())
                continue
            job = _Job(req, respond,
                       "shutdown" if cmd == "shutdown" else "run")
            jobs.put(job)
            pending.append(job)
            if job.kind == "shutdown":
                break
        # keep the socket open until this connection's jobs responded
        for job in pending:
            job.done.wait()


def serve_forever(server: SegmentationServer, socket_path: str | None = None,
                  host: str | None = None, port: int | None = None,
                  ready=None, log=print, idle_timeout: float = 30.0,
                  max_request_bytes: int = 1 << 20, prep_fn=None,
                  queue_depth: int = 64):
    """Accept-loop until a shutdown request. ``ready(address)`` is called
    once listening (tests use it to learn the ephemeral TCP port).

    Device execution is single-flight in FIFO arrival order; a prep stage
    (``prep_fn(req) -> prepared``, optional) overlaps the next queued
    request's host-side read, decode and upload with the current request's
    device compute. At most ONE request is prepared ahead of the executing
    one: the prep stage takes the one slot before it calls ``prep_fn`` and
    the exec stage gives it back when it takes the prepared job, so device
    memory holds at most one waiting request's uploads.
    A wedged client cannot block the queue: a connection that sends no
    complete request line within ``idle_timeout`` seconds (0: no limit) is
    dropped, and a request line longer than ``max_request_bytes`` is
    rejected with an error response and the connection closed (a request
    is a file path + options — anything near a megabyte is a protocol
    violation, not a workload)."""
    srv, address = _bind(socket_path, host, port)
    if log:
        log(f"seg_serve: listening on {address} (model {server.model_dir})")
    if ready is not None:
        ready(address)

    jobs: _queue.Queue = _queue.Queue(maxsize=max(1, queue_depth))
    execq: _queue.Queue = _queue.Queue(maxsize=1)
    ahead = threading.Semaphore(1)  # the one prepared-ahead slot
    stop_evt = threading.Event()

    def prep_loop():
        while True:
            job = jobs.get()
            ahead.acquire()  # wait until the previous job started executing
            if (job is not None and job.kind == "run" and prep_fn is not None
                    and not stop_evt.is_set()):
                try:
                    with tracing.bound(job.within):
                        job.prepared = prep_fn(job.req)
                except Exception as e:  # surfaced by the exec stage
                    job.prep_error = e
            execq.put(job)
            if job is None:
                return

    def accept_loop():
        while not stop_evt.is_set():
            try:
                conn, _ = srv.accept()
            except OSError:
                break  # socket closed by shutdown
            threading.Thread(
                target=_reader,
                args=(conn, server, jobs, idle_timeout, max_request_bytes,
                      log, stop_evt), name="serve-reader", daemon=True).start()

    prep_t = threading.Thread(target=prep_loop, name="serve-prep", daemon=True)
    accept_t = threading.Thread(target=accept_loop, name="serve-accept", daemon=True)
    prep_t.start()
    accept_t.start()

    try:
        while True:  # exec stage: single-flight device execution, FIFO
            job = execq.get()
            ahead.release()  # this job runs now: the next one may be prepared
            if job is None:
                break
            try:
                if job.kind == "shutdown":
                    job.respond({"ok": True, "shutdown": True})
                    break
                job.pending.end()
                if job.prep_error is not None:
                    job.respond({"ok": False, "error":
                                 f"{type(job.prep_error).__name__}: "
                                 f"{job.prep_error}"})
                else:
                    with tracing.bound(job.within):
                        job.respond(server.run(job.req, prepared=job.prepared))
            finally:
                job.done.set()
    finally:
        stop_evt.set()
        try:
            srv.shutdown(socket.SHUT_RDWR)  # wakes a BLOCKED accept()
        except OSError:
            pass
        srv.close()

        def drain(q):
            # fail still-queued jobs loudly instead of dropping silently
            while True:
                try:
                    j = q.get_nowait()
                except _queue.Empty:
                    return
                if j is not None and not j.done.is_set():
                    j.respond({"ok": False,
                               "error": "server shut down before this "
                                        "request was executed"})
                    j.done.set()
        drain(jobs)      # BEFORE the sentinel: a drain racing the prep
        jobs.put(None)   # thread's get() must not steal its None
        deadline = time.time() + 5
        while prep_t.is_alive() and time.time() < deadline:
            drain(execq)     # frees a prep thread blocked in execq.put()
            ahead.release()  # ... or waiting for the prepared-ahead slot
            prep_t.join(timeout=0.05)
        drain(execq)
        drain(jobs)       # anything a late reader enqueued
        accept_t.join(timeout=5)
        if socket_path is not None and os.path.exists(socket_path):
            os.unlink(socket_path)
    if log:
        log(f"seg_serve: shut down after {server.served} case(s)")


def request(address, obj: dict, timeout: float = 600.0) -> dict:
    """One-shot client: connect, send ``obj``, return the response dict.
    ``address`` is a Unix-socket path or a ``(host, port)`` tuple."""
    if isinstance(address, str):
        c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    else:
        c = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        address = tuple(address)
    c.settimeout(timeout)
    with c:
        c.connect(address)
        c.sendall((json.dumps(obj) + "\n").encode("utf-8"))
        rf = c.makefile("r", encoding="utf-8")
        line = rf.readline()
    if not line:
        raise ConnectionError("server closed the connection without a reply")
    return json.loads(line)
