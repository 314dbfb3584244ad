"""A warm ``seg_serve`` deployment under a closed loop of clients.

Set-up makes the pool and the model, starts ``seg_serve``'s ``main`` in a
thread of this process on a Unix socket, and warms it with one request per
pool case (every shape the window sends). In the window ``clients``
threads each send one case per request, in the pool's seeded cycle, and
send the next when the answer comes; none is sent after ``--seconds``, and
every request sent is waited for. ``request_p90_s`` is the 90th percentile
of all requests' seconds from send to answer on the client's clock.

The socket is ``portbench.sock`` in the run's scratch directory under
``TMPDIR``; where that path would pass 100 bytes (``AF_UNIX`` takes 107),
the process changes into the directory and names the socket relatively.
"""
from __future__ import annotations

import os
import statistics
import threading
import time

import torch

from portbench import devtrace, flops
from portbench.drivers.common import Inputs, check_masks
from portbench.drivers.infer import boxes_of

SOCKET = "portbench.sock"


def percentile(values, q):
    """The ``q``-th percentile of ``values`` by the nearest rank."""
    s = sorted(values)
    return s[max(0, min(len(s) - 1, -(-len(s) * q // 100) - 1))]


def server_argv(ctx, model, sock):
    tr = ctx.traffic
    argv = ["-m", model, "--socket", sock, "--partition_type", tr["partition_type"],
            "--partition_size", *map(str, tr["patch"][::-1]),
            "--partition_stride", *map(str, tr["stride"][::-1]),
            "--batch_size", str(tr["batch_size"]), "--blend", tr["blend"],
            "-n", tr["seg_name"], "--idle_timeout", "0"]
    if tr["dtype"] == "bfloat16":
        argv.append("--bf16")
    dev = torch.device(ctx.device)
    return argv + ["-g", str(dev.index or 0) if dev.type == "cuda" else "-1"]


def run(ctx):
    from segmentation3d_tpu_torch.cli.seg_serve import main as serve_main
    from segmentation3d_tpu_torch.core.serve import request
    tr, cfg = ctx.traffic, ctx.cfg
    inputs = Inputs(ctx)
    dev = torch.device(ctx.device)
    sock = os.path.join(ctx.tmp, SOCKET)
    cwd = os.getcwd()
    if len(sock.encode()) > 100:
        os.chdir(ctx.tmp)
        sock = SOCKET
    server = threading.Thread(target=serve_main, args=(server_argv(ctx, inputs.model, sock),),
                              daemon=True)
    server.start()
    try:
        return _drive(ctx, inputs, dev, sock, request, server)
    finally:
        os.chdir(cwd)


def _wait_for(sock, request, server, seconds=120.0):
    t = time.perf_counter()
    while time.perf_counter() - t < seconds and server.is_alive():
        try:
            return request(sock, {"cmd": "ping"}, timeout=5.0)
        except OSError:
            time.sleep(0.05)
    raise RuntimeError("the server did not come up")


def _drive(ctx, inputs, dev, sock, request, server):
    tr, cfg = ctx.traffic, ctx.cfg
    seg_name = tr["seg_name"]
    _wait_for(sock, request, server)
    for i, path in enumerate(inputs.paths):
        resp = request(sock, {"input": path, "output_dir": os.path.join(ctx.tmp, f"warm{i}")})
        if not resp.get("ok"):
            raise RuntimeError(f"warm-up request failed: {resp}")
    seconds = tr["trace_seconds"] if ctx.trace else ctx.seconds
    order = inputs.cycle(tr["max_requests"])
    lock = threading.Lock()
    done, errors, sent = [], [], [0]

    def client():
        while True:
            with lock:
                k = sent[0]
                if time.perf_counter() >= deadline or k >= len(order):
                    return
                sent[0] += 1
            out = os.path.join(ctx.tmp, "out", f"r{k}")
            t = time.perf_counter()
            try:
                resp = request(sock, {"input": inputs.paths[order[k]], "output_dir": out})
            except OSError as e:
                resp = {"ok": False, "error": repr(e)}
            t1 = time.perf_counter()
            with lock:
                (done if resp.get("ok") else errors).append((k, t, t1, resp, out))

    path = os.path.join(ctx.tmp, "trace.json")
    with devtrace.profiled(path, ctx.trace):
        t0 = time.perf_counter()
        deadline = t0 + seconds
        threads = [threading.Thread(target=client) for _ in range(tr["clients"])]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        t1 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    trace = devtrace.reduce(path) if ctx.trace else None
    request(sock, {"cmd": "shutdown"})
    server.join(60)
    if server.is_alive():
        raise RuntimeError("the server did not shut down")
    from segmentation3d_tpu_torch.core import seg_infer
    seg_infer._SESSIONS.clear()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    done.sort()
    secs = [b - a for _, a, b, _, _ in done]
    written = []
    for k, _, _, resp, out in done:
        for name, *_ in resp["results"]:
            written.append((order[k], os.path.join(out, name, seg_name)))
    nums, ref_s = check_masks(ctx, inputs, written, tr["check_masks"])
    attempted = sent[0]
    failed = attempted - len(written)
    run = {
        "attempted": attempted, "failed": failed, "memory_peak_bytes": peak,
        "e2e": {"request_p90_s": percentile(secs, 90) if secs else float("inf"),
                "setup_s": t0 - ctx.t_start},
        "request_s": secs,
        "queue_s": [b - a - resp["secs"] for _, a, b, resp, _ in done],
        "window_s": t1 - t0, "trace": trace,
        "boxes": [boxes_of(inputs.pool[order[k]], cfg, tr) for k, *_ in done],
        "batch": tr["batch_size"], "patch": tr["patch"],
        "forward_flops": flops.forward_flops(cfg["net"], tr["patch"]),
        "peak": flops.peaks(), "reference_s": ref_s,
    }
    lim = ctx.limits
    run["checks"] = [("failed", failed, 0), ("masks_unreadable", nums["masks_unreadable"], 0)]
    run["checks"] += [(name, nums[name], lim[name]) for name in lim["compared"]]
    run["diagnostics"] = dict(nums, requests=len(done), errors=[e[3] for e in errors][:3],
                              median_s=statistics.median(secs) if secs else None,
                              reference_s=ref_s)
    print(f"portbench: {run['diagnostics']}")
    run["correct"] = all(v <= limit for _, v, limit in run["checks"])
    return run
