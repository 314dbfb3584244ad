"""What the per-layer metric readers (``metrics/<name>.py``) share.

Each reader takes a driver's result (``run``) and returns a number or
None when the run holds nothing to read. A share of a peak or a roofline is
never made up: where its inputs are missing, the reader returns None.
"""
from __future__ import annotations

import statistics

from portbench import flops


def median_stage(run, stage):
    vals = [s[stage] for _, _, s in run.get("results", ()) if stage in s]
    return statistics.median(vals) if vals else None


def median(values):
    return statistics.median(values) if values else None


def idle_share(run):
    tr = run.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def window_s(run):
    tr = run.get("trace")
    return tr.window_s if tr is not None else None


def mfu(run, useful_flops):
    """Useful operations over the traced window's seconds and the bf16 peak."""
    w = window_s(run)
    if not w or not useful_flops:
        return None
    return 100.0 * useful_flops / w / run["peak"]["bf16_flops"]


def infer_flops(run):
    return sum(run["boxes"]) * run["forward_flops"]


def is_thin_conv(name):
    """A kernel of ``csrc/thin_conv3d.cu``: its direct kernel, or the shared
    wgmma mainloop instantiated with its op (not the int8 kernel's)."""
    return ("conv_direct_kernel" in name and "i8" not in name) or \
        ("conv_wgmma_kernel" in name and "I8Op" not in name)


def thin_conv_roofline(run):
    """Least seconds of every ``thin_conv3d`` launch of the traced window
    (the harness's own site table times the batches each case ran, the
    last one partial) over the kernels' seconds in the device trace."""
    tr, sites = run.get("trace"), run.get("thin_conv_sites")
    if tr is None or not sites:
        return None
    secs = tr.kernels(is_thin_conv)
    bs, patch, least, n = run["batch"], run["patch"], 0.0, 0
    for boxes in run["boxes"]:
        sizes = [bs] * (boxes // bs) + ([boxes % bs] if boxes % bs else [])
        for b in sizes:
            for _, cin, cout, scale in sites:
                ops, nbytes = flops.thin_conv_launch(b, patch, cin, cout, scale)
                least += flops.least_seconds(ops, nbytes, run["peak"])
                n += 1
    if not secs or len(secs) != n or n != run.get("thin_conv_launches"):
        return None
    return 100.0 * least / sum(secs)


def step_device_ms(run):
    tr, steps = run.get("trace"), run.get("steps")
    if tr is None or not steps:
        return None
    return 1e3 * tr.busy_s / steps


def prefetch_wait_share(run):
    st = run.get("stats") or {}
    if not st.get("loop_seconds"):
        return None
    return 100.0 * st["prefetch_wait_seconds"] / st["loop_seconds"]
