"""Operations and bytes of the configurations' convolutions, from their widths.

:func:`conv_sites` walks a V-Net or VB-Net as the toolkit builds it and
lists every convolution with its kernel size, channels and the voxels it
writes per voxel of the input patch. A convolution costs ``2 k^3 Cin Cout``
operations per output voxel; a 2^3 stride-2 transposed convolution feeds
each output voxel from one tap, ``2 Cin Cout``. BatchNorm, activations and
the softmax are left out (memory-bound and under 0.1% of the operations).

:func:`thin_conv_launch` gives the operations and the least bytes of one
stride-1 3^3 site of the folded bf16 forward, where the program's
``thin_conv3d`` kernel computes it: bf16 input and output, each read or
written once, and the bf16 weights and float32 bias.
"""
from __future__ import annotations

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def peaks() -> dict:
    """The card's published peaks (``peaks/h100.json``)."""
    with open(os.path.join(HERE, "peaks", "h100.json")) as f:
        return json.load(f)


def conv_sites(net: dict):
    """``[(name, k, cin, cout, scale, transposed)]``: ``scale`` is the
    site's output voxels over the patch's voxels."""
    base, cls = net["base_channels"], net["num_classes"]
    bott = net["name"] == "vbnet"
    sites = [("in_block/conv", 3, net["in_channels"], base, 1.0, False)]

    def residual(prefix, c, n, scale):
        for i in range(n):
            key = f"{prefix}/res/conv{i}"
            if bott:
                mid = max(1, c // 4)
                sites.extend([(f"{key}/reduce", 1, c, mid, scale, False),
                              (f"{key}/conv", 3, mid, mid, scale, False),
                              (f"{key}/expand", 1, mid, c, scale, False)])
            else:
                sites.append((key, 3, c, c, scale, False))

    c, scale = base, 1.0
    for n in net["down_convs"]:
        scale /= 8.0
        sites.append((f"down_{2 * c}/down", 2, c, 2 * c, scale, False))
        c *= 2
        residual(f"down_{c}", c, n, scale)
    prev = c
    for n in net["up_convs"]:
        scale *= 8.0
        sites.append((f"up_{c}/up", 2, prev, c // 2, scale, True))
        residual(f"up_{c}", c, n, scale)
        prev, c = c, c // 2
    sites.append(("out_block/conv", 3, prev, cls, 1.0, False))
    sites.append(("out_block/proj", 1, cls, cls, 1.0, False))
    return sites


def site_flops(k, cin, cout, transposed):
    """Operations per output voxel."""
    return 2.0 * cin * cout * (1 if transposed else k ** 3)


def forward_flops(net: dict, patch_zyx) -> float:
    """Operations of one forward of one patch."""
    v = float(patch_zyx[0] * patch_zyx[1] * patch_zyx[2])
    return sum(site_flops(k, ci, co, t) * s * v
               for _, k, ci, co, s, t in conv_sites(net))


def thin_conv_sites(net: dict):
    """The stride-1 3^3 sites of the folded forward, ``[(name, cin, cout,
    scale)]``: 20 for the default V-Net. A VB-Net has no folded forward."""
    if net["name"] != "vnet":
        return []
    return [(n, ci, co, s) for n, k, ci, co, s, t in conv_sites(net)
            if k == 3 and not t]


def thin_conv_launch(batch, patch_zyx, cin, cout, scale):
    """``(operations, bytes)`` of one launch on ``batch`` patches."""
    v = batch * patch_zyx[0] * patch_zyx[1] * patch_zyx[2] * scale
    ops = 2.0 * 27 * cin * cout * v
    nbytes = 2.0 * v * (cin + cout) + 2.0 * 27 * cin * cout + 4.0 * cout
    return ops, nbytes


def least_seconds(ops, nbytes, peak: dict) -> float:
    return max(ops / peak["bf16_flops"], nbytes / peak["hbm_bytes_per_s"])
