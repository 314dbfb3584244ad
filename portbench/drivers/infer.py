"""``seg_infer`` over a folder: one ``segmentation()`` call on a case list.

Set-up makes the pool and the model, then runs the pool through
``segmentation()`` twice with the cell's engine options: the first pass
loads the model, folds it, builds the kernels and warms every shape; the
second times a warm pass, whose rate sizes the window's list to whole
cycles of the pool. The window is one ``segmentation()`` call on that list,
fill and drain included; ``volumes_per_min`` is its cases over its seconds.
A traced run profiles a call on ``trace_cases`` cases instead.
"""
from __future__ import annotations

import os
import time

import torch

from portbench import devtrace, flops
from portbench.drivers.common import (Inputs, check_masks, engine_options,
                                      pool_index, write_list)
from portbench.reference import pipeline


def boxes_of(case, cfg, traffic):
    grid = pipeline.iso_size(case["hu"].shape, case["spacing_zyx"],
                             cfg["spacing_mm"][::-1], traffic["shape_bucket"])
    return len(pipeline.boxes(grid, traffic["patch"], traffic["stride"]))


def run(ctx):
    from segmentation3d_tpu_torch.core import seg_infer
    from segmentation3d_tpu_torch.ops.thin_conv import thin_conv3d
    tr, cfg = ctx.traffic, ctx.cfg
    inputs = Inputs(ctx)
    opts = engine_options(tr)
    dev = torch.device(ctx.device)
    seg_name = tr["seg_name"]

    def call(indices, tag):
        listing = os.path.join(ctx.tmp, f"{tag}.txt")
        write_list(listing, [inputs.paths[i] for i in indices])
        out = os.path.join(ctx.tmp, tag)
        t0 = time.perf_counter()
        res = seg_infer.segmentation(listing, inputs.model, out, seg_name=seg_name,
                                     device=dev, **opts)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return res, out, t0, time.perf_counter()

    k = len(inputs.pool)
    call(range(k), "warm0")
    _, _, a, b = call(range(k), "warm1")
    if ctx.trace:
        n = tr["trace_cases"]
    else:
        n = max(k, k * round(ctx.seconds * k / (b - a) / k))
    order = inputs.cycle(n)
    launches0 = thin_conv3d.launches
    path = os.path.join(ctx.tmp, "trace.json")
    with devtrace.profiled(path, ctx.trace):
        results, out, t0, t1 = call(order, "window")
    launches = thin_conv3d.launches - launches0
    setup_s = t0 - ctx.t_start
    window_s = t1 - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    trace = devtrace.reduce(path) if ctx.trace else None
    seg_infer._SESSIONS.clear()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    written = [(pool_index(name), os.path.join(out, name, seg_name))
               for name, _, _ in results]
    nums, ref_s = check_masks(ctx, inputs, written, tr["check_masks"])
    failed = len(order) - len(results)
    boxes = [boxes_of(inputs.pool[i], cfg, tr) for i, _ in written]
    patch = tr["patch"]
    run = {
        "attempted": len(order), "failed": failed, "memory_peak_bytes": peak,
        "e2e": {"volumes_per_min": len(results) * 60.0 / window_s, "setup_s": setup_s},
        "results": results, "window_s": window_s, "trace": trace,
        "boxes": boxes, "batch": tr["batch_size"], "patch": patch,
        "forward_flops": flops.forward_flops(cfg["net"], patch),
        "thin_conv_sites": flops.thin_conv_sites(cfg["net"]),
        "thin_conv_launches": launches, "peak": flops.peaks(),
        "reference_s": ref_s,
    }
    lim = ctx.limits
    run["checks"] = [("failed", failed, 0), ("masks_unreadable", nums["masks_unreadable"], 0)]
    run["checks"] += [(name, nums[name], lim[name]) for name in lim["compared"]]
    run["diagnostics"] = dict(nums, launches=launches, reference_s=ref_s)
    print(f"portbench: {run['diagnostics']}")
    run["correct"] = all(v <= limit for _, v, limit in run["checks"])
    return run
