"""Plain inference of one case, and the gap by which a mask departs from it.

What a user of the toolkit's ``seg_infer`` asks for, written out plainly:
the volume resampled linearly to the model's spacing (voxels outside the
source read 0), the grid padded up to a multiple of the shape bucket,
intensities normalised with the model's fixed normaliser, the grid cut into
boxes of ``patch`` voxels whose starts advance by ``stride`` (the last box
of an axis ends at the grid's edge), each box's class probabilities from
the float32 net, pasted with Gaussian weights (sigma an eighth of the box
on each axis, floored at a thousandth of the peak), divided by the weights'
sum, and mapped back to the native grid by nearest neighbour.

Axis-aligned volumes with one origin only (what the benchmark writes). All
float32 with TF32 off. Tensors are ``[Z, Y, X]``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.nets import exact

#: a native voxel whose nearest iso voxel lies this close to a tie (in iso
#: voxels) may round either way in another float order: both count
TIE = 1e-3


def iso_size(size_zyx, spacing_zyx, new_spacing_zyx, bucket):
    """The resampled grid's size: the physical extent over the new spacing,
    rounded up, then up to a multiple of ``bucket``."""
    out = []
    for n, s, t in zip(size_zyx, spacing_zyx, new_spacing_zyx):
        m = math.ceil(n * s / t - 1e-6)
        out.append(int(math.ceil(m / bucket) * bucket))
    return tuple(out)


def _linear_axis(v, axis, n_out, ratio):
    """Linear interpolation along ``axis`` at source coordinates
    ``i * ratio``; samples outside ``[0, n_in - 1]`` read 0."""
    n_in = v.shape[axis]
    c = torch.arange(n_out, dtype=torch.float64, device=v.device) * ratio
    valid = (c >= 0) & (c <= n_in - 1)
    f = torch.floor(c).clamp(0, n_in - 1)
    t = (c - f).to(torch.float32)
    lo = f.long()
    hi = (lo + 1).clamp(max=n_in - 1)
    shape = [1] * v.dim()
    shape[axis] = n_out
    a = v.index_select(axis, lo)
    b = v.index_select(axis, hi)
    t = t.view(shape)
    out = a * (1 - t) + b * t
    return out * valid.view(shape).to(out.dtype)


def resample(vol, spacing_zyx, new_spacing_zyx, out_zyx):
    """``vol`` (any dtype) as float32 on the new grid, linearly."""
    v = vol.to(torch.float32)
    for ax in range(3):
        v = _linear_axis(v, ax, out_zyx[ax],
                         new_spacing_zyx[ax] / spacing_zyx[ax])
    return v


def box_starts(size, patch, stride):
    last = size - patch
    starts = list(range(0, last + 1, stride))
    if starts[-1] != last:
        starts.append(last)
    return starts


def boxes(shape_zyx, patch_zyx, stride_zyx):
    axes = [box_starts(n, p, s) for n, p, s in zip(shape_zyx, patch_zyx, stride_zyx)]
    return [(z, y, x) for z in axes[0] for y in axes[1] for x in axes[2]]


def gaussian_weights(patch_zyx, device):
    g = [torch.exp(-0.5 * (torch.linspace(-1, 1, n, dtype=torch.float64) / 0.25) ** 2)
         for n in patch_zyx]
    w = g[0][:, None, None] * g[1][None, :, None] * g[2][None, None, :]
    w = torch.maximum(w, w.max() * 1e-3)
    return w.to(device=device, dtype=torch.float32)


#: boxes per forward of the reference: the memory of a batch, nothing more
BATCH = 8


@torch.no_grad()
def probabilities(net, vol, spacing_zyx, cfg, traffic):
    """Class probabilities ``[C, Z, Y, X]`` of the float32 ``net`` (eval
    mode, on ``vol``'s device) on the padded iso grid of the native volume
    ``vol``."""
    new_sp = list(cfg["spacing_mm"])[::-1]
    grid = iso_size(vol.shape, spacing_zyx, new_sp, traffic["shape_bucket"])
    norm = cfg["normalizer"]
    x = resample(vol, spacing_zyx, new_sp, grid)
    x = ((x - norm["mean"]) / norm["stddev"])
    if norm["clip"]:
        x = x.clamp(-1.0, 1.0)
    patch = tuple(min(p, g) for p, g in zip(traffic["patch"], grid))
    stride = tuple(min(s, p) for s, p in zip(traffic["stride"], patch))
    w = gaussian_weights(patch, vol.device)
    classes = cfg["net"]["num_classes"]
    acc = torch.zeros((classes,) + grid, device=vol.device)
    wsum = torch.zeros(grid, device=vol.device)
    starts = boxes(grid, patch, stride)
    pz, py, px = patch
    with exact():
        for i in range(0, len(starts), BATCH):
            chunk = starts[i:i + BATCH]
            xb = torch.stack([x[z:z + pz, y:y + py, q:q + px] for z, y, q in chunk])
            p = net.probs(xb[:, None])
            for (z, y, q), pb in zip(chunk, p):
                acc[:, z:z + pz, y:y + py, q:q + px] += pb * w
                wsum[z:z + pz, y:y + py, q:q + px] += w
    return acc / wsum.clamp_min(1e-8)


def _nearest(n_native, ratio, n_iso, device):
    """Per native index: the iso index it maps to, and the other one where
    the coordinate lies within :data:`TIE` of a tie."""
    c = np.arange(n_native, dtype=np.float64) * ratio
    lo = np.floor(c + 0.5)
    frac = c - np.floor(c)
    alt = np.where(np.abs(frac - 0.5) < TIE,
                   np.where(lo > c, lo - 1, lo + 1), lo)
    lo, alt = (torch.from_numpy(np.clip(a, 0, n_iso - 1).astype(np.int64)).to(device)
               for a in (lo, alt))
    return lo, alt


@torch.no_grad()
def mask_gaps(prob, mask, spacing_zyx, new_spacing_zyx, z_chunk=16):
    """For each native voxel of ``mask`` (the class the program wrote), by
    how much the reference's probability of that class lies below the
    reference's best class at the iso voxel it maps to, the least over
    rounding ties. Returns the widest gap (``mask_gap``) and the shares of
    voxels whose gap is above 0 (``mask_disagree``), 0.05 and 0.2."""
    dev = prob.device
    best = prob.max(0).values
    maps = [_nearest(n, s / t, g, dev) for n, s, t, g in
            zip(mask.shape, spacing_zyx, new_spacing_zyx, prob.shape[1:])]
    mask = mask.to(dev).long()
    widest, above = 0.0, torch.zeros(3, dtype=torch.float64)
    edges = torch.tensor([0.0, 0.05, 0.2], device=dev)
    (zl, za), (yl, ya), (xl, xa) = maps
    for z0 in range(0, mask.shape[0], z_chunk):
        m = mask[z0:z0 + z_chunk]
        gap = None
        for zi in (zl[z0:z0 + z_chunk], za[z0:z0 + z_chunk]):
            for yi in (yl, ya):
                for xi in (xl, xa):
                    idx = (zi[:, None, None], yi[None, :, None], xi[None, None, :])
                    g = best[idx] - prob[(m,) + idx]
                    gap = g if gap is None else torch.minimum(gap, g)
        widest = max(widest, float(gap.max()))
        above += (gap.reshape(-1, 1) > edges).sum(0).cpu().double()
    share = (above / mask.numel()).tolist()
    return {"mask_gap": widest, "mask_disagree": share[0],
            "mask_disagree_05": share[1], "mask_disagree_20": share[2]}
