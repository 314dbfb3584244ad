"""``seg_infer`` over a folder with a SwinUNETR: one ``segmentation()`` call on a case list.

As :mod:`portbench.drivers.infer`, with the configuration's SwinUNETR:
set-up makes the pool and the seeded reference net
(:mod:`portbench.swin_weights`), writes it as the program's checkpoint
(``net: swin_unetr`` with its ``net_kwargs``), and runs the pool through
``segmentation()`` twice (the first pass loads the model and warms every
shape, the second sizes the window's list to whole cycles of the pool).
The window is one ``segmentation()`` call; ``volumes_per_min`` is its cases
over its seconds. A traced run profiles a call on ``trace_cases`` cases
and keeps, before the trace file goes, the device seconds of the kernels
launched inside the program's ``swin.encoder`` and
``swin.window_attention`` ranges (:func:`portbench.ranges.kernel_seconds`).

A program that does not know the net fails at once, before any set-up.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from portbench import cases, devtrace, flops, ranges, swin_flops, swin_weights
from portbench.drivers import common
from portbench.drivers.common import check_masks, engine_options, pool_index, write_list
from portbench.drivers.infer import boxes_of
from portbench.reference import swin_unetr

#: the program's ranges whose kernels a traced run keeps
RANGES = ("swin.encoder", "swin.window_attention")
#: the net's widths that its checkpoint records
NET_KWARGS = ("feature_size", "depths", "num_heads", "window_size")


def model_dir(ctx, net):
    """A model directory holding ``net``'s state dict, written by the
    program's checkpoint writer."""
    from segmentation3d_tpu_torch.utils.model_io import save_checkpoint
    from segmentation3d_tpu_torch.utils.normalizer import FixedNormalizer
    cfg, n, norm = ctx.cfg, ctx.cfg["net"], ctx.cfg["normalizer"]
    path = os.path.join(ctx.tmp, "model")
    save_checkpoint(path, 1, 0, net.state_dict(), n["name"], swin_flops.MAX_STRIDE,
                    n["in_channels"], n["num_classes"], cfg["spacing_mm"], "LINEAR",
                    [FixedNormalizer(norm["mean"], norm["stddev"], norm["clip"])],
                    extra={"net_kwargs": {k: n[k] for k in NET_KWARGS}})
    return path


class Inputs(common.Inputs):
    """The pool (on the device and as files), the seeded reference SwinUNETR
    (eval mode) and the program's model directory."""

    def __init__(self, ctx):
        dev = torch.device(ctx.device)
        self.pool = cases.make_pool(ctx.seed, ctx.traffic["pool"], dev)
        self.paths = cases.write_pool(self.pool, os.path.join(ctx.tmp, "pool"))
        self.net = swin_weights.seeded(swin_unetr.build(ctx.cfg), ctx.seed, ctx.cfg, dev)
        self.model = model_dir(ctx, self.net)
        self.rng = np.random.default_rng(ctx.seed)
        self.reference = {}


def run(ctx):
    from segmentation3d_tpu_torch.models import get_network_module
    from segmentation3d_tpu_torch.core import seg_infer
    tr, cfg = ctx.traffic, ctx.cfg
    get_network_module(cfg["net"]["name"])   # raises at once where the net is not ported
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
    n = tr["trace_cases"] if ctx.trace else max(k, k * round(ctx.seconds * k / (b - a) / k))
    order = inputs.cycle(n)
    path = os.path.join(ctx.tmp, "trace.json")
    with devtrace.profiled(path, ctx.trace):
        results, out, t0, t1 = call(order, "window")
    setup_s, window_s = t0 - ctx.t_start, t1 - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    range_s = ranges.kernel_seconds(path, RANGES) if ctx.trace else {}
    trace = devtrace.reduce(path) if ctx.trace else None
    seg_infer._SESSIONS.clear()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    written = [(pool_index(name), os.path.join(out, name, seg_name)) for name, _, _ in results]
    nums, ref_s = check_masks(ctx, inputs, written, tr["check_masks"])
    failed = len(order) - len(results)
    patch = tr["patch"]
    run = {
        "attempted": len(order), "failed": failed, "memory_peak_bytes": peak,
        "e2e": {"volumes_per_min": len(results) * 60.0 / window_s, "setup_s": setup_s},
        "results": results, "window_s": window_s, "trace": trace,
        "boxes": [boxes_of(inputs.pool[i], cfg, tr) for i, _ in written],
        "batch": tr["batch_size"], "patch": patch,
        "forward_flops": swin_flops.forward_flops(cfg["net"], patch),
        "attention_calls": swin_flops.attention_calls(cfg["net"], patch),
        "head_dim": cfg["net"]["feature_size"] // cfg["net"]["num_heads"][0],
        "range_kernel_s": range_s, "peak": flops.peaks(), "reference_s": ref_s,
    }
    lim = ctx.limits
    run["checks"] = [("failed", failed, 0), ("masks_unreadable", nums["masks_unreadable"], 0)]
    run["checks"] += [(name, nums[name], lim[name]) for name in lim["compared"]]
    run["diagnostics"] = dict(nums, reference_s=ref_s, range_kernel_s=range_s)
    print(f"portbench: {run['diagnostics']}")
    run["correct"] = all(v <= limit for _, v, limit in run["checks"])
    return run
