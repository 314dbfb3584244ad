"""Elastic deformation augmentation — a coarse-grid warp on the device.

The port of ``segmentation3d_tpu/ops/elastic.py``: a displacement field
drawn on a coarse control-point grid is upsampled trilinearly to the crop
shape and applied as a gather resample; the label crop takes the nearest
sample of the same field, so image and label stay consistent.

``jax.image.resize(..., "trilinear")`` samples the coarse grid at
half-pixel centres, ``(i + 0.5) * g / n - 0.5``, and near the borders
renormalises the triangle kernel's weights over the grid points inside,
which gives the edge point itself; ``F.interpolate(mode="trilinear",
align_corners=False)`` samples at the same points and clamps them to the
edge, which gives the same value. ``tests/test_torch_port_train_data.py``
holds the two dense fields to 1e-5.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def dense_field(disp, shape_zyx):
    """``disp [gz, gy, gx, 3]`` -> ``[D, H, W, 3]`` trilinear upsampling with
    half-pixel centres (``jax.image.resize``'s "trilinear")."""
    d = disp.to(torch.float32).permute(3, 0, 1, 2)[None]
    up = F.interpolate(d, size=tuple(int(s) for s in shape_zyx),
                       mode="trilinear", align_corners=False)
    return up[0].permute(1, 2, 3, 0)


def elastic_warp(image, seg, disp):
    """Warp an image crop and its label crop with one displacement field.

    ``image``: [D,H,W,C] float; ``seg``: [D,H,W] integer; ``disp``:
    [gz,gy,gx,3] control-point displacements in VOXELS (z,y,x order in the
    last axis), any coarse grid size >= 2 per axis. Returns
    ``(warped_image, warped_seg)``. Sample coordinates are clamped to the
    crop (edge replication — no fill labels are invented)."""
    D, H, W = (int(s) for s in seg.shape)
    dev = image.device
    dense = dense_field(disp.to(dev), (D, H, W))
    cz = torch.arange(D, dtype=torch.float32, device=dev)[:, None, None] + dense[..., 0]
    cy = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None] + dense[..., 1]
    cx = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :] + dense[..., 2]
    cz = torch.clamp(cz, 0.0, D - 1.0)
    cy = torch.clamp(cy, 0.0, H - 1.0)
    cx = torch.clamp(cx, 0.0, W - 1.0)

    img32 = image.to(torch.float32)

    def gather_img(zi, yi, xi):
        return img32[zi.clamp(0, D - 1), yi.clamp(0, H - 1), xi.clamp(0, W - 1)]

    fz, fy, fx = torch.floor(cz), torch.floor(cy), torch.floor(cx)
    tz, ty, tx = cz - fz, cy - fy, cx - fx
    fz, fy, fx = fz.long(), fy.long(), fx.long()
    out = 0.0
    for bz in (0, 1):
        wz = (1 - tz) if bz == 0 else tz
        for by in (0, 1):
            wy = (1 - ty) if by == 0 else ty
            for bx in (0, 1):
                wx = (1 - tx) if bx == 0 else tx
                w = (wz * wy * wx)[..., None]
                out = out + w * gather_img(fz + bz, fy + by, fx + bx)
    warped_image = out.to(image.dtype)

    # labels: nearest sample of the SAME field (label-preserving)
    nz = torch.floor(cz + 0.5).long().clamp(0, D - 1)
    ny = torch.floor(cy + 0.5).long().clamp(0, H - 1)
    nx = torch.floor(cx + 0.5).long().clamp(0, W - 1)
    return warped_image, seg[nz, ny, nx]
