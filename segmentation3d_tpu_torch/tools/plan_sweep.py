"""Time the wgmma path of both conv kernels under other launch plans.

For each wide site of the main paths (batch 8, 96^3 patches), runs
``thin_conv3d`` (bf16) and ``window_conv_i8`` (int8) with every box depth
``mt`` the kernel is built for and a ring of up to 1, 2 or 3 stages, checks
each output against the default plan's, and prints one JSON line per run:
the plan, milliseconds per launch (CUDA events, after a warm-up) and
whether it is the default plan. Needs one CUDA device.

    python -m segmentation3d_tpu_torch.tools.plan_sweep [--sites up_32 head]
"""
from __future__ import annotations

import argparse
import functools
import json
import subprocess

import torch

from segmentation3d_tpu_torch.ops import conv_plan, thin_conv, window_i8

# (name, spatial size, cin, cout) at batch 8
SITES = [("up_32", 96, 32, 32), ("head", 96, 32, 2), ("down_32", 48, 32, 32),
         ("up_64", 48, 64, 64), ("up_128", 24, 128, 128),
         ("up_256", 12, 256, 256), ("down_256", 6, 256, 256)]


def _ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def sweep(names=None):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    for name, s, ci, co in SITES:
        if names and name not in names:
            continue
        xb = torch.randn(8, s, s, s, ci, device=dev, generator=g).to(torch.bfloat16)
        wb = (torch.randn(3, 3, 3, ci, co, device=dev, generator=g)
              * (2.0 / (27 * ci)) ** 0.5).to(torch.bfloat16)
        b = torch.randn(co, device=dev, generator=g) * 0.1
        xi = torch.randint(-127, 128, (8, s, s, s, ci), device=dev, generator=g,
                           dtype=torch.int16).to(torch.int8)
        wi = torch.randint(-127, 128, (3, 3, 3, ci, co), device=dev, generator=g,
                           dtype=torch.int16).to(torch.int8)
        sc = torch.full((co,), 1e-4, device=dev)
        runs = {
            "bf16": (thin_conv, 2, lambda: thin_conv.thin_conv3d(xb, wb, b, act="relu")),
            "int8": (window_i8, 1, lambda: window_i8.window_conv_i8(
                xi, wi, sc, b, "relu", inv_out=20.0)),
        }
        for kind, (mod, eb, fn) in runs.items():
            default = conv_plan.plan_conv(8, s, s, s, ci, co, eb)
            ref = fn()
            for mt in conv_plan.MT_CHOICES[default.bn]:
                for stages in (1, 2, 3):
                    plan = conv_plan.plan_conv(8, s, s, s, ci, co, eb, mt=mt,
                                               max_stages=stages)
                    if plan.stages < stages:
                        continue
                    mod.plan_conv = functools.partial(conv_plan.plan_conv, mt=mt,
                                                      max_stages=stages)
                    try:
                        same = bool(torch.equal(fn(), ref))
                        ms = _ms(fn, 20 if s <= 48 else 10)
                    finally:
                        mod.plan_conv = conv_plan.plan_conv
                    print(json.dumps(dict(
                        site=name, kind=kind, shape=[8, s, s, s, ci], cout=co,
                        **plan.summary(), ms=ms, equal_to_default=same,
                        default=plan == default, gpu=gpu)), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sites", nargs="*", help="site names (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("plan_sweep needs a CUDA device")
    sweep(args.sites)


if __name__ == "__main__":
    main()
