"""World-frame geometry for 3D medical volumes.

Re-implements the geometric bookkeeping of the reference toolkit
(``segmentation3d/utils/image_tools.py``: ``get_image_frame`` /
``set_image_frame`` ≈L10-40, box partition ``image_partition_by_fixed_size``
≈L230-280) on plain numpy, with ITK conventions:

- voxel arrays are indexed ``[z, y, x]`` (C-order; x fastest on disk),
- a :class:`Frame` carries ``origin``/``spacing``/``direction`` in **(x, y, z)
  physical (LPS) order**, and maps voxel index ``(ix, iy, iz)`` to the physical
  point ``origin + direction @ (spacing * index)``.

All functions here are host-side pure math (no device tensors); the
device-side resampling built on top lives in
:mod:`segmentation3d_tpu_torch.ops.resample`. The port's own copy of
``segmentation3d_tpu/ops/geometry.py``.
"""
from __future__ import annotations

import dataclasses
import numpy as np


@dataclasses.dataclass(frozen=True)
class Frame:
    """Physical frame of a volume: origin, spacing, direction (ITK/LPS).

    ``origin``: (3,) physical coordinates of voxel (0,0,0), xyz order.
    ``spacing``: (3,) voxel size along the x/y/z index axes.
    ``direction``: (3,3) matrix whose COLUMNS are the physical unit vectors of
    the x/y/z index axes (identity for axis-aligned volumes).
    """

    origin: np.ndarray
    spacing: np.ndarray
    direction: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "origin", np.asarray(self.origin, np.float64).reshape(3))
        object.__setattr__(self, "spacing", np.asarray(self.spacing, np.float64).reshape(3))
        object.__setattr__(self, "direction", np.asarray(self.direction, np.float64).reshape(3, 3))

    @staticmethod
    def identity(spacing=(1.0, 1.0, 1.0), origin=(0.0, 0.0, 0.0)) -> "Frame":
        return Frame(np.asarray(origin, np.float64), np.asarray(spacing, np.float64), np.eye(3))

    # ---- voxel <-> world ----------------------------------------------------
    def index_to_world_matrix(self) -> np.ndarray:
        """4x4 affine mapping homogeneous voxel index (ix,iy,iz,1) -> physical xyz."""
        m = np.eye(4)
        m[:3, :3] = self.direction @ np.diag(self.spacing)
        m[:3, 3] = self.origin
        return m

    def world_to_index_matrix(self) -> np.ndarray:
        return np.linalg.inv(self.index_to_world_matrix())

    def index_to_world(self, idx_xyz) -> np.ndarray:
        idx = np.asarray(idx_xyz, np.float64)
        return (self.direction @ (self.spacing * idx).T).T + self.origin

    def world_to_index(self, pts_xyz) -> np.ndarray:
        pts = np.asarray(pts_xyz, np.float64)
        return ((np.linalg.inv(self.direction) @ (pts - self.origin).T).T) / self.spacing

    def voxel_center_world(self, size_xyz) -> np.ndarray:
        """Physical point of the volume center (in continuous index space)."""
        center_idx = (np.asarray(size_xyz, np.float64) - 1.0) / 2.0
        return self.index_to_world(center_idx)

    # ---- (de)serialisation --------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "origin": self.origin.tolist(),
            "spacing": self.spacing.tolist(),
            "direction": self.direction.reshape(-1).tolist(),
        }

    @staticmethod
    def from_dict(d: dict) -> "Frame":
        return Frame(np.asarray(d["origin"]), np.asarray(d["spacing"]),
                     np.asarray(d["direction"], np.float64).reshape(3, 3))

    def isclose(self, other: "Frame", tol: float = 1e-5) -> bool:
        return (np.allclose(self.origin, other.origin, atol=tol)
                and np.allclose(self.spacing, other.spacing, atol=tol)
                and np.allclose(self.direction, other.direction, atol=tol))


def frame_for_crop(frame: Frame, center_world, out_size_xyz, out_spacing_xyz) -> Frame:
    """Frame of a crop of ``out_size`` voxels at ``out_spacing``, centered on
    ``center_world``, keeping the source direction.

    Mirrors the origin computation of the reference ``crop_image``
    (``utils/image_tools.py`` ≈L50-90): the crop's continuous-index center maps
    onto ``center_world``.
    """
    out_size = np.asarray(out_size_xyz, np.float64)
    out_spacing = np.asarray(out_spacing_xyz, np.float64)
    center_idx = (out_size - 1.0) / 2.0
    origin = np.asarray(center_world, np.float64) - frame.direction @ (out_spacing * center_idx)
    return Frame(origin, out_spacing, frame.direction)


def resampled_frame(frame: Frame, size_xyz, new_spacing_xyz, pad_to_multiple: int = 1):
    """Frame + voxel size after resampling a whole volume to ``new_spacing``.

    Keeps the origin/direction; the new size covers the same physical extent
    (``ceil``), then is padded UP to a multiple of ``pad_to_multiple`` —
    reproducing the reference's ``resample_spacing(..., max_stride)`` behavior
    (``utils/image_tools.py`` ≈L185-220) where output dims are made divisible
    by the network's ``max_stride``.

    Returns ``(new_frame, new_size_xyz: np.ndarray[int])``.
    """
    size = np.asarray(size_xyz, np.float64)
    new_spacing = np.asarray(new_spacing_xyz, np.float64)
    phys_extent = size * frame.spacing
    new_size = np.ceil(phys_extent / new_spacing - 1e-6).astype(np.int64)
    if pad_to_multiple > 1:
        new_size = (np.ceil(new_size / pad_to_multiple) * pad_to_multiple).astype(np.int64)
    new_size = np.maximum(new_size, 1)
    return Frame(frame.origin.copy(), new_spacing, frame.direction.copy()), new_size


def partition_boxes(size_xyz, partition_size_xyz, stride_xyz):
    """Overlapping sliding-window boxes covering a volume.

    Re-implements the box math of ``image_partition_by_fixed_size``
    (``utils/image_tools.py`` ≈L230-280): starts advance by ``stride`` and the
    final start is clamped so the last box ends exactly at the volume edge
    (boxes never exceed the volume; full coverage is guaranteed when
    ``partition_size <= size``).

    Returns an (N, 3) int array of box starts in xyz voxel coordinates.
    """
    size = np.asarray(size_xyz, np.int64)
    psize = np.asarray(partition_size_xyz, np.int64)
    stride = np.asarray(stride_xyz, np.int64)
    if np.any(psize > size):
        raise ValueError(f"partition size {psize} exceeds volume size {size}")
    if np.any(stride <= 0):
        raise ValueError(f"stride must be positive, got {stride}")
    per_axis = []
    for ax in range(3):
        last = size[ax] - psize[ax]
        starts = list(range(0, int(last) + 1, int(stride[ax])))
        if starts[-1] != last:
            starts.append(int(last))
        per_axis.append(np.asarray(starts, np.int64))
    gx, gy, gz = np.meshgrid(per_axis[0], per_axis[1], per_axis[2], indexing="ij")
    return np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=-1)


def num_partition_by_size(size_xyz, partition_number_xyz):
    """Partition size/stride for a fixed NUMBER of boxes per axis (the
    reference's ``partition_type='NUM'`` mode, ``core/seg_infer.py`` [M])."""
    size = np.asarray(size_xyz, np.int64)
    num = np.asarray(partition_number_xyz, np.int64)
    psize = np.ceil(size / num).astype(np.int64)
    return psize, psize
