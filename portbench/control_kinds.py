"""Readings that set the correctness limits of the cells whose kinds ``control.py`` lacks.

    python3 portbench/control_kinds.py --workload <cell> --seeds 11,12,13

``infer_swin``: for each seed, the cell's set-up, then over one pass of the
pool the compared numbers of the program as the cell runs it (the lower
readings), of the program in float32 (a witness that sides with the
reference), and of the reference SwinUNETR with its convolutions and linear
layers in fp8 (:func:`portbench.reference.swin_unetr.low_net`; the control).

``train_ddp``: for each seed, the cell's ranks on a short window (a warm
call of 2 steps, then 8), the program's gaps on the window's first three
global batches, and those of the reference in fp8 (its convolutions,
:func:`portbench.reference.lowp.low_net`) on the same batches; then the
ranks again with each fault of the limits' ``control.program`` that exists
only across GPUs (:data:`FAULTS`), each against the reference on its own
batches.

One JSON line per seed. Needs the cell's CUDA devices; the benchmark's own
runs never run this.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") not in (HERE, ROOT)]

import torch  # noqa: E402

from portbench import control  # noqa: E402
from portbench.drivers import common, infer_swin, train_ddp  # noqa: E402
from portbench.manifest import Cell, load  # noqa: E402
from portbench.reference import lowp, nets, pipeline, swin_unetr, train_ref  # noqa: E402
from portbench.run import Context  # noqa: E402


def swin_readings(ctx):
    from segmentation3d_tpu_torch.core import seg_infer
    inputs = infer_swin.Inputs(ctx)
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
           "program_float32": program("float32", dtype=torch.float32)}
    new_sp = tuple(ctx.cfg["spacing_mm"][::-1])
    for kind in ctx.limits["control"]["reference"]:
        low, nums = swin_unetr.low_net(inputs.net, kind), {}
        for i, case in enumerate(inputs.pool):
            p = pipeline.probabilities(low, case["hu"], case["spacing_zyx"], ctx.cfg, ctx.traffic)
            mask = control.native_mask(p, case["hu"].shape, case["spacing_zyx"], new_sp)
            got = pipeline.mask_gaps(inputs.reference[i], mask, case["spacing_zyx"], new_sp)
            nums = {k: max(v, nums.get(k, 0.0)) for k, v in got.items()}
        out[f"reference_{kind}"] = nums
    return out


def no_allreduce():
    """Each rank steps on its own gradient: DDP's all-reduce left out."""
    import torch.nn.parallel
    torch.nn.parallel.DistributedDataParallel = lambda net, **_: net


def local_bn():
    """Each rank's BatchNorm normalizes its own two crops."""
    from segmentation3d_tpu_torch.core import seg_train
    from segmentation3d_tpu_torch.models.vnet import distribute_
    seg_train.distribute_ = lambda net, batch_group, z_group: distribute_(net, None, z_group)


#: faults of the four-GPU path, each a function a rank calls before training
FAULTS = {"no_allreduce": no_allreduce, "local_bn": local_bn}


def ddp_readings(ctx):
    ctx.traffic = dict(ctx.traffic, warm_steps=2)
    ctx.seconds = 0.0
    ranks, start, _ = train_ddp.spawn(ctx, 0)
    dev = torch.device(ctx.device)
    cap = train_ddp.global_capture(ranks, dev)
    cfg, tr = ctx.cfg, ctx.traffic
    ref = train_ref.reference_run(cfg, tr, start, cap.batches, dev)
    out = {"program": train_ref.gaps(ref, train_ref.captured(cap, start, dev))}
    for kind in ctx.limits["control"]["reference"]:
        low = lowp.low_net(nets.build(cfg), kind)
        out[f"reference_{kind}"] = train_ref.gaps(
            ref, train_ref.reference_run(cfg, tr, start, cap.batches, dev, net=low))
    for fault in ctx.limits["control"].get("program", ()):
        ranks, start, _ = train_ddp.spawn(ctx, 0, FAULTS[fault])
        cap = train_ddp.global_capture(ranks, dev)
        ref = train_ref.reference_run(cfg, tr, start, cap.batches, dev)
        out[f"program_{fault}"] = train_ref.gaps(ref, train_ref.captured(cap, start, dev))
    return out


READINGS = {"infer_swin": swin_readings, "train_ddp": ddp_readings}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    cell = Cell(load(), args.workload)
    if not torch.cuda.is_available():
        print("control_kinds: no CUDA device", file=sys.stderr)
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="portbench-control-") as tmp:
            ctx = Context(copy.deepcopy(cell), seed, 0.0, False, tmp)
            out = READINGS[cell.traffic["kind"]](ctx)
        print(json.dumps({"cell": cell.name, "seed": seed, **out,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
