"""``seg_train`` over several GPUs: one rank a GPU, each calling ``train_ranks``.

The cell's chips are the ranks. Set-up makes the pool with its labels and
the seeded initial weights (as :mod:`portbench.drivers.train`), writes a
warm and a window save dir, each holding ``chk_0`` of those weights, and
spawns one process per rank. Each sets torchrun's variables (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``) and calls the program's ``train_ranks`` twice: a warm call
of ``warm_steps`` steps (it joins the group by the program's rule, NCCL with
a GPU a rank, loads the cases and tunes cuDNN; rank 0's steps between its
first and last loss readback, 8 steps apart, size the window, and rank 0
writes the window's config),
then the window call, of as many steps as fill ``--seconds``
(``trace_steps`` in a traced run, profiled on rank 0). ``crops_per_s`` is the window's steps times the global batch
over rank 0's ``loop_seconds``; set-up ends where rank 0's window loop
takes its first batch.

Each rank wraps the program's ``train_step`` for the window's first three
steps (:class:`portbench.drivers.train.Capture`) and saves its crops,
labels and losses; rank 0 also the first gradient as Adam holds it and the
weights after three steps. The global batch of a step is the ranks' rows in
rank order (the program's ``local_rows``), and the plain float32 reference
follows the three steps from ``chk_0`` on it, BatchNorm over all eight
crops, as one process would.
"""
from __future__ import annotations

import os
import socket
import time
import types

import torch

from portbench import devtrace, flops, spans
from portbench.drivers import train
from portbench.reference import nets, train_ref

#: where a rank saves what it captured and timed
OUT = "rank{}.pt"
#: seconds the ranks may take beyond four windows (start, joins, warm call)
DEADLINE = 600.0


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _wait_for(path, seconds=600.0):
    t = time.perf_counter()
    while not os.path.exists(path):
        if time.perf_counter() - t > seconds:
            raise TimeoutError(f"{path} did not appear in {seconds} s")
        time.sleep(0.05)


def _module_names(leaves):
    """Leaves under the net's own names (DDP's carry ``module.``), on the CPU."""
    return {k.removeprefix("module."): v.cpu() for k, v in leaves.items()}


def _rank(rank, job):
    """One rank: the job's ``before`` (a fault a control injects), the
    warm call, then the captured (and on rank 0 profiled) window call;
    saves ``OUT`` under the job's folder, rank 0 also the program's spans
    and counters of the window."""
    world = job["world"]
    if job["before"] is not None:
        job["before"]()
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1")
    from segmentation3d_tpu_torch.core import seg_train
    gpu = 0 if job["cuda"] else -1
    os.environ["MASTER_PORT"] = str(job["ports"][0])
    warm = {}
    seg_train.train_ranks(job["warm"], gpu_id=gpu, stats=warm)
    window = os.path.join(job["tmp"], "window.py")
    out = {}
    if rank == 0:
        # the warm call's first loss readback ends its cuDNN tuning and its
        # first read of each case; the steps from there to the last readback
        # are what the window repeats
        (s0, t0, _), (s1, t1, _) = warm["flushes"][0], warm["flushes"][-1]
        step_s = (t1 - t0) / (s1 - s0) if s1 > s0 else warm["loop_seconds"] / warm["steps"]
        steps = job["trace_steps"] or max(8, int(round(job["seconds"] / step_s)))
        ctx = types.SimpleNamespace(cfg=job["cfg"], traffic=job["traffic"])
        train.write_config(ctx, window + ".tmp", job["window_dir"], job["imseg"], steps)
        os.replace(window + ".tmp", window)
        out.update(warm_step_s=step_s, steps_asked=steps)
    else:
        _wait_for(window)
    os.environ["MASTER_PORT"] = str(job["ports"][1])
    cap = train.Capture(seg_train)
    stats = {}
    with devtrace.profiled(job["trace_path"], bool(job["trace_steps"]) and rank == 0):
        seg_train.train_ranks(window, gpu_id=gpu, stats=stats)
    out.update(batches=[(x.cpu(), y.cpu()) for x, y in cap.batches],
               losses=[float(x) for x in cap.losses], stats=stats, t_first=cap.t_first,
               peak=torch.cuda.max_memory_allocated() if job["cuda"] else 0)
    if rank == 0:
        out.update(grad1=_module_names(cap.grad1), after=_module_names(cap.after),
                   program_spans=spans.taken({}))
    torch.save(out, os.path.join(job["tmp"], OUT.format(rank)))


def global_capture(ranks, device):
    """The window's first three steps as one process would have seen them:
    each step's crops and labels of every rank in rank order, the mean of
    the ranks' losses, rank 0's first gradient and weights after three."""
    batches = [(torch.cat([r["batches"][i][0] for r in ranks]).to(device),
                torch.cat([r["batches"][i][1] for r in ranks]).to(device))
               for i in range(len(ranks[0]["batches"]))]
    losses = [sum(r["losses"][i] for r in ranks) / len(ranks)
              for i in range(len(ranks[0]["losses"]))]
    to = lambda d: {k: v.to(device) for k, v in d.items()}  # noqa: E731
    return types.SimpleNamespace(batches=batches, losses=losses,
                                 grad1=to(ranks[0]["grad1"]), after=to(ranks[0]["after"]))


def spawn(ctx, trace_steps, before=None):
    """Set up the two save dirs and run the ranks, each calling ``before``
    (a function of no arguments, or None) first; returns each rank's saved
    dict in rank order, the initial weights and the job. A rank that fails
    fails the run, and so do ranks that have not ended within
    :data:`DEADLINE` seconds plus four windows (they are ended first)."""
    import torch.multiprocessing as mp
    imseg, start = train.prepare(ctx)
    world = ctx.cell.entry["chips"]
    dirs = {}
    for tag in ("warm", "window"):
        dirs[tag] = os.path.join(ctx.tmp, tag)
        net = nets.build(ctx.cfg)
        net.load_state_dict(start)
        train.initial_checkpoint(ctx, dirs[tag], net)
    warm_cfg = os.path.join(ctx.tmp, "warm.py")
    train.write_config(ctx, warm_cfg, dirs["warm"], imseg, ctx.traffic["warm_steps"])
    job = {"world": world, "cuda": torch.device(ctx.device).type == "cuda",
           "ports": _free_ports(2), "warm": warm_cfg, "window_dir": dirs["window"],
           "imseg": imseg, "tmp": ctx.tmp, "cfg": ctx.cfg, "traffic": ctx.traffic,
           "seconds": ctx.seconds, "trace_steps": trace_steps,
           "trace_path": os.path.join(ctx.tmp, "trace.json"), "before": before}
    procs = mp.start_processes(_rank, args=(job,), nprocs=world, start_method="spawn",
                               join=False)
    deadline = time.perf_counter() + DEADLINE + 4 * ctx.seconds
    try:
        while not procs.join(timeout=1.0):
            if time.perf_counter() > deadline:
                raise TimeoutError(f"the {world} ranks did not end in time")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
    return [torch.load(os.path.join(ctx.tmp, OUT.format(r)), weights_only=False)
            for r in range(world)], start, job


def run(ctx):
    tr, cfg = ctx.traffic, ctx.cfg
    dev = torch.device(ctx.device)
    ranks, start, job = spawn(ctx, tr["trace_steps"] if ctx.trace else 0)
    trace = devtrace.reduce(job["trace_path"]) if ctx.trace else None
    stats = ranks[0]["stats"]
    setup_s = ranks[0]["t_first"] - ctx.t_start
    t = time.perf_counter()
    cap = global_capture(ranks, dev)
    gaps = train_ref.compare(cfg, tr, start, cap, dev)
    ref_s = time.perf_counter() - t
    batch, world = tr["batch_size"], len(ranks)
    done, attempted = stats.get("steps", 0), ranks[0]["steps_asked"]
    run = {
        "attempted": attempted, "failed": attempted - done,
        "memory_peak_bytes": max(r["peak"] for r in ranks),
        "e2e": {"crops_per_s": done * batch / stats["loop_seconds"], "setup_s": setup_s},
        "stats": stats, "steps": done, "trace": trace, "peak": flops.peaks(),
        # rank 0's share of a step, against one chip's peak
        "step_flops": 3.0 * batch / world * flops.forward_flops(cfg["net"], cfg["crop"]),
        spans.KEY: ranks[0]["program_spans"], "reference_s": ref_s,
    }
    lim = ctx.limits
    run["checks"] = [("failed", attempted - done, 0)] + [
        (name, gaps[name], lim[name]) for name in lim["compared"]]
    run["diagnostics"] = dict(gaps, warm_step_s=ranks[0]["warm_step_s"], steps=done,
                              reference_s=ref_s, ranks=len(ranks),
                              losses=[round(x, 6) for x in cap.losses])
    print(f"portbench: {run['diagnostics']}")
    run["correct"] = all(v <= limit for _, v, limit in run["checks"])
    return run
