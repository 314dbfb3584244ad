"""Readings that set a cell's correctness limits, at the cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13

For each seed: the cell's set-up, then the numbers that a run compares,
read from the program as the cell runs it (the lower readings) and from
the cell's control (``limits/<cell>.json``, ``control``): the program's
own int8 path (``seg_infer --int8 --int8_calib``), or the float32
reference with its convolutions in fp8 or int8 (:mod:`portbench.reference.lowp`)
put in the program's place; for training also the fault of a batch half
left out (the program's step given the first half of each batch). One JSON
line per seed. Needs a CUDA device; the benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") not in (HERE, ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench.drivers import common  # noqa: E402
from portbench.manifest import Cell, load  # noqa: E402
from portbench.reference import lowp, nets, pipeline, train_ref  # noqa: E402
from portbench.run import Context  # noqa: E402


def native_mask(prob, shape_zyx, spacing_zyx, new_spacing_zyx):
    """The argmax of iso-grid probabilities, nearest neighbour onto the
    native grid (round half up)."""
    lab = prob.argmax(0)
    idx = [torch.from_numpy(np.clip(np.floor(np.arange(n) * s / t + 0.5), 0, g - 1)
                            .astype(np.int64)).to(prob.device)
           for n, s, t, g in zip(shape_zyx, spacing_zyx, new_spacing_zyx, lab.shape)]
    return lab[idx[0][:, None, None], idx[1][None, :, None], idx[2][None, None, :]]


def infer_readings(ctx, inputs, control):
    """The compared numbers over one pass of the pool: of the program as
    the cell runs it, in float32 (a witness that sides with the reference),
    and of each control the cell's limits name (``quant``: the program's
    own path; ``reference``: the reference in that precision)."""
    from segmentation3d_tpu_torch.core import seg_infer
    opts = common.engine_options(ctx.traffic)
    seg_name = ctx.traffic["seg_name"]

    def program(tag, **extra):
        listing = os.path.join(ctx.tmp, f"{tag}.txt")
        common.write_list(listing, inputs.paths)
        out = os.path.join(ctx.tmp, tag)
        res = seg_infer.segmentation(listing, inputs.model, out, seg_name=seg_name,
                                     device=torch.device(ctx.device), **{**opts, **extra})
        seg_infer._SESSIONS.clear()
        written = [(common.pool_index(n), os.path.join(out, n, seg_name)) for n, _, _ in res]
        return common.check_masks(ctx, inputs, written, len(written))[0]

    out = {"program": program("program"),
           "program_float32": program("float32", dtype=torch.float32, fused=False)}
    if "quant" in control:
        extra = {"quant": control["quant"]}
        if control.get("calib"):
            extra["calib_image"] = inputs.paths[0]
        out["program_" + control["quant"]] = program("control", **extra)
    for kind in control.get("reference", ()):
        new_sp = tuple(ctx.cfg["spacing_mm"][::-1])
        low, nums = lowp.low_net(inputs.net, kind), {}
        for i, case in enumerate(inputs.pool):
            p = pipeline.probabilities(low, case["hu"], case["spacing_zyx"],
                                       ctx.cfg, ctx.traffic)
            mask = native_mask(p, case["hu"].shape, case["spacing_zyx"], new_sp)
            got = pipeline.mask_gaps(inputs.reference[i], mask, case["spacing_zyx"], new_sp)
            nums = {k: max(v, nums.get(k, 0.0)) for k, v in got.items()}
        out[f"reference_{kind}"] = nums
    return out


def train_readings(ctx):
    """The program's three compared numbers, the fp8 reference's and the
    half-batch fault's, from one set-up."""
    from portbench.drivers import train as drv
    from segmentation3d_tpu_torch.core import seg_train
    tr, cfg, dev = ctx.traffic, ctx.cfg, torch.device(ctx.device)
    out = {}
    real = seg_train.train_step

    def half(net, optimizer, loss_fn, images, segs, **kw):
        b = images.shape[0] // 2
        return real(net, optimizer, loss_fn, images[:b], segs[:b], **kw)

    for tag in ("program", "fault_half_batch"):
        seg_train.train_step = half if tag != "program" else real
        try:
            cap, start = drv.window_capture(ctx, steps=3, tag=tag)
        finally:
            seg_train.train_step = real
        batches = [(x.to(dev), y.to(dev)) for x, y in cap.batches]
        ref = train_ref.reference_run(cfg, tr, start, batches, dev)
        out[tag] = train_ref.gaps(ref, train_ref.captured(cap, start, dev))
        if tag == "program":
            for kind in ctx.limits["control"]["reference"]:
                low = lowp.low_net(nets.build(cfg), kind)
                out[f"reference_{kind}"] = train_ref.gaps(
                    ref, train_ref.reference_run(cfg, tr, start, batches, dev, net=low))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    cell = Cell(load(), args.workload)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="portbench-control-") as tmp:
            ctx = Context(cell, seed, 0.0, False, tmp)
            if cell.traffic["kind"] == "train":
                out = train_readings(ctx)
            else:
                out = infer_readings(ctx, common.Inputs(ctx), cell.limits["control"])
        print(json.dumps({"cell": cell.name, "seed": seed, **out,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
