"""Fixed-spacing resampling on the device, with ITK's semantics.

The port of ``segmentation3d_tpu/ops/resample.py`` (``resample_plan``,
``resample_exec``, the two cores under them, ``resample_to_frame`` and
``crop_at_world_center``):

- **Separable path** (source and target share an axis-aligned direction):
  1-D linear/NN interpolation along each axis is a dense ``[out, in]``
  interpolation matrix, applied as three einsums in float32 with TF32 off
  (the JAX package runs them at ``Precision.HIGH``).
- **General path** (arbitrary direction matrices): a chunked trilinear/NN
  gather over the output volume.

A training crop reads only its :func:`source_box`: given ``box``, the cores
take that part of the volume and weight it by exactly the columns of the
whole volume's interpolation, judged against the whole volume's bounds, so
the crop is the same (NN bit for bit; LINEAR up to float32 summation order).

Boundary semantics follow ITK's ``ResampleImageFilter``: sample points whose
continuous source index falls outside ``[0, size-1]`` get the fill value;
NN rounds half up (``floor(c + 0.5)``); integer outputs are rounded with
``rint``. ``grid_sample`` is not used: its border rules differ.

Tensors are ``[D, H, W]`` (= [z, y, x]) or channels-last ``[D, H, W, C]``.
"""
from __future__ import annotations

import itertools
from typing import NamedTuple

import numpy as np
import torch

from segmentation3d_tpu_torch.ops.geometry import Frame, frame_for_crop
from segmentation3d_tpu_torch.utils.device import no_tf32

LINEAR = "LINEAR"
NN = "NN"


def _compose_dst_to_src(src_frame: Frame, dst_frame: Frame) -> np.ndarray:
    """4x4 affine taking dst voxel index (xyz, homogeneous) -> src voxel index."""
    return src_frame.world_to_index_matrix() @ dst_frame.index_to_world_matrix()


def _is_separable(m: np.ndarray, tol: float = 1e-9) -> bool:
    off = m[:3, :3] - np.diag(np.diag(m[:3, :3]))
    return bool(np.all(np.abs(off) <= tol))


class SourceBox(NamedTuple):
    """Index box ``[lo, hi)`` (zyx) of a volume of ``size`` (zyx) voxels."""
    lo: tuple
    hi: tuple
    size: tuple

    @property
    def slices(self) -> tuple:
        return tuple(slice(a, b) for a, b in zip(self.lo, self.hi))


def source_box(frame: Frame, size_zyx, center_world, out_size_xyz,
               out_spacing_xyz) -> SourceBox:
    """The smallest box of a ``size_zyx`` volume in ``frame`` that holds every
    voxel :func:`crop_at_world_center` reads for this crop: the crop grid's
    corners mapped to source indices in float64, ``floor(min)`` to
    ``floor(max) + 1`` (the trilinear neighbour), widened by a bound on the
    cores' float32 rounding of those indices and clipped to the volume. A
    crop wholly outside keeps one edge voxel, which it weights by zero."""
    crop_frame = frame_for_crop(frame, center_world, out_size_xyz, out_spacing_xyz)
    m = _compose_dst_to_src(frame, crop_frame)
    last = np.asarray(out_size_xyz, np.float64) - 1.0
    corners = np.array(list(itertools.product(*[(0.0, n) for n in last])))
    c = corners @ m[:3, :3].T + m[:3, 3]
    tol = 1e-6 * (1.0 + np.abs(m[:3, :3]) @ last + np.abs(m[:3, 3]))
    top = np.asarray(size_zyx, np.int64)[::-1] - 1
    lo = np.clip(np.floor(c.min(axis=0) - tol), 0, top).astype(np.int64)
    hi = np.clip(np.floor(c.max(axis=0) + tol) + 1, 0, top).astype(np.int64) + 1
    return SourceBox(tuple(lo[::-1].tolist()), tuple(hi[::-1].tolist()),
                     tuple(int(n) for n in size_zyx))


def _interp_matrix(out_n: int, in_n: int, a, b, interp: str, device, lo: int,
                   n: int):
    """Columns ``lo .. lo + n - 1`` of the dense [out_n, in_n] 1-D
    interpolation matrix for src coord c = a*i + b. Rows of out-of-range
    samples are all-zero (ITK's default pixel value for a zero fill)."""
    i = torch.arange(out_n, dtype=torch.float32, device=device)[:, None]
    j = torch.arange(lo, lo + n, dtype=torch.float32, device=device)[None, :]
    c = a * i + b
    valid = (c >= 0.0) & (c <= in_n - 1.0)
    if interp == NN:
        idx = torch.floor(c + 0.5)  # ITK RoundHalfIntegerUp
        w = (j == torch.clamp(idx, 0, in_n - 1)).to(torch.float32)
    else:
        f = torch.floor(c)
        t = c - f
        w = torch.where(j == f, 1.0 - t, 0.0) + torch.where(j == f + 1.0, t, 0.0)
    return torch.where(valid, w, 0.0)


def _separable_core(data, coeffs, out_shape, interp=LINEAR, fill=0.0,
                    out_dtype=None, lo=(0, 0, 0), size=None):
    squeeze = data.dim() == 3
    if squeeze:
        data = data[..., None]
    in_shape = data.shape[:3]
    size = size or in_shape
    res_dtype = out_dtype or data.dtype
    x = data.to(torch.float32)
    coeffs = torch.as_tensor(coeffs, dtype=torch.float32, device=data.device)
    ws = [_interp_matrix(out_shape[ax], size[ax], coeffs[ax, 0], coeffs[ax, 1],
                         interp, data.device, lo[ax], in_shape[ax])
          for ax in range(3)]

    def apply(v):
        v = torch.einsum("Zd,dhwc->Zhwc", ws[0], v)
        v = torch.einsum("Yh,dhwc->dYwc", ws[1], v)
        return torch.einsum("Xw,dhwc->dhXc", ws[2], v)

    with no_tf32():
        x = apply(x)
        if fill != 0.0:
            # out-of-range rows contributed 0; add fill where total weight < 1
            cov = apply(torch.ones(tuple(in_shape) + (1,), dtype=torch.float32,
                                   device=data.device))
            x = x + (1.0 - cov) * fill
    if not res_dtype.is_floating_point:
        x = torch.round(x)  # half to even, as jnp.rint
    x = x.to(res_dtype)
    return x[..., 0] if squeeze else x


def _affine_core(data, matrix, out_shape, interp=LINEAR, fill=0.0, z_chunk=8,
                 out_dtype=None, lo=(0, 0, 0), size=None):
    squeeze = data.dim() == 3
    if squeeze:
        data = data[..., None]
    dz, dy, dx = out_shape
    sz, sy, sx = size or data.shape[:3]
    lz, ly, lx = lo
    hz, hy, hx = (a + n - 1 for a, n in zip(lo, data.shape[:3]))
    dev = data.device
    x32 = data.to(torch.float32)
    m = torch.as_tensor(matrix, dtype=torch.float32, device=dev)
    chunks = []
    for z0 in range(0, dz, z_chunk):
        nz = min(z_chunk, dz - z0)
        oz = torch.arange(z0, z0 + nz, dtype=torch.float32, device=dev)[:, None, None]
        oy = torch.arange(dy, dtype=torch.float32, device=dev)[None, :, None]
        ox = torch.arange(dx, dtype=torch.float32, device=dev)[None, None, :]
        # dst index xyz -> src index xyz
        cx = m[0, 0] * ox + m[0, 1] * oy + m[0, 2] * oz + m[0, 3]
        cy = m[1, 0] * ox + m[1, 1] * oy + m[1, 2] * oz + m[1, 3]
        cz = m[2, 0] * ox + m[2, 1] * oy + m[2, 2] * oz + m[2, 3]
        valid = ((cx >= 0) & (cx <= sx - 1.0) & (cy >= 0) & (cy <= sy - 1.0)
                 & (cz >= 0) & (cz <= sz - 1.0))

        def gather(zi, yi, xi):
            return x32[zi.clamp(lz, hz) - lz, yi.clamp(ly, hy) - ly,
                       xi.clamp(lx, hx) - lx]  # [nz, dy, dx, C]

        if interp == NN:
            out = gather(torch.floor(cz + 0.5).long(), torch.floor(cy + 0.5).long(),
                         torch.floor(cx + 0.5).long())
        else:
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
                        out = out + w * gather(fz + bz, fy + by, fx + bx)
        chunks.append(torch.where(valid[..., None], out, fill))
    out = torch.cat(chunks, dim=0)
    res_dtype = out_dtype or data.dtype
    if not res_dtype.is_floating_point:
        out = torch.round(out)
    out = out.to(res_dtype)
    return out[..., 0] if squeeze else out


def resample_plan(src_frame: Frame, dst_frame: Frame, dst_size_xyz):
    """Host-side planning for a frame-to-frame resample: returns
    ``(kind, coeffs, out_shape)`` with ``kind`` in {"sep", "aff"} and
    ``coeffs`` a numpy float32 array."""
    m = _compose_dst_to_src(src_frame, dst_frame)
    nx, ny, nz = (int(v) for v in dst_size_xyz)
    out_shape = (nz, ny, nx)
    if _is_separable(m):
        # coeffs per output axis (z,y,x): src_axis_coord = a*out_idx + b
        coeffs = np.array([
            [m[2, 2], m[2, 3]],  # z
            [m[1, 1], m[1, 3]],  # y
            [m[0, 0], m[0, 3]],  # x
        ], np.float32)
        return "sep", coeffs, out_shape
    return "aff", np.asarray(m[:3], np.float32), out_shape


def resample_exec(data: torch.Tensor, kind: str, coeffs, out_shape,
                  interp: str = LINEAR, fill: float = 0.0, out_dtype=None,
                  box: SourceBox | None = None):
    """Execute a :func:`resample_plan` on ``data``'s device; given ``box``,
    ``data`` is only that part of the volume."""
    lo, size = (box.lo, box.size) if box is not None else ((0, 0, 0), None)
    if kind == "sep":
        return _separable_core(data, coeffs, out_shape, interp, fill, out_dtype,
                               lo, size)
    return _affine_core(data, coeffs, out_shape, interp, fill,
                        out_dtype=out_dtype, lo=lo, size=size)


def resample_to_frame(data: torch.Tensor, src_frame: Frame, dst_frame: Frame,
                      dst_size_xyz, interp: str = LINEAR, fill: float = 0.0,
                      out_dtype=None):
    """Resample ``data`` (living in ``src_frame``) onto a target frame and
    grid, on ``data``'s device: ``[nz, ny, nx(, C)]`` for
    ``dst_size_xyz = (nx, ny, nz)``."""
    kind, coeffs, out_shape = resample_plan(src_frame, dst_frame, dst_size_xyz)
    return resample_exec(data, kind, coeffs, out_shape, interp, fill, out_dtype)


def crop_at_world_center(data: torch.Tensor, frame: Frame, center_world,
                         out_size_xyz, out_spacing_xyz, interp: str = LINEAR,
                         fill: float = 0.0, box: SourceBox | None = None):
    """Fixed-spacing crop of ``out_size_xyz`` voxels centred on a physical
    point, keeping ``frame``'s direction. Returns ``(tensor, crop_frame)``.
    Given this crop's :func:`source_box`, ``data`` is only that box of the
    volume, and the crop is the same."""
    crop_frame = frame_for_crop(frame, center_world, out_size_xyz,
                                out_spacing_xyz)
    kind, coeffs, out_shape = resample_plan(frame, crop_frame, out_size_xyz)
    out = resample_exec(data, kind, coeffs, out_shape, interp, fill, box=box)
    return out, crop_frame
