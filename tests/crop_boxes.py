"""A crop's source box counted from the geometry alone (``Frame`` methods,
not ``ops.resample``), for the tests that hold ``source_box`` and the bytes
the training data stage uploads against it. Imports no JAX."""
import itertools

import numpy as np


def box_bounds(frame, size_zyx, crop_frame, crop_size_xyz):
    """``(lo, hi)`` (zyx, ``hi`` exclusive) of the voxels of a ``size_zyx``
    volume in ``frame`` that a crop of ``crop_size_xyz`` voxels in
    ``crop_frame`` reads: its eight corners' source indices, ``floor(min)``
    to ``floor(max) + 1``, widened by 1e-6 of the indices' scale (the
    float32 rounding of the resample cores) and clipped to the volume."""
    last = np.asarray(crop_size_xyz, np.float64) - 1.0
    corners = np.array(list(itertools.product(*[(0.0, n) for n in last])))
    idx = frame.world_to_index(crop_frame.index_to_world(corners))
    origin = frame.world_to_index(crop_frame.origin)
    steps = frame.world_to_index(crop_frame.index_to_world(np.eye(3))) - origin
    tol = 1e-6 * (1.0 + np.abs(steps).T @ last + np.abs(origin))
    top = np.asarray(size_zyx)[::-1] - 1
    lo = np.clip(np.floor(idx.min(axis=0) - tol), 0, top)
    hi = np.clip(np.floor(idx.max(axis=0) + tol) + 1, 0, top) + 1
    return lo[::-1].astype(int), hi[::-1].astype(int)


def box_voxels(frame, size_zyx, crop_frame, crop_size_xyz):
    lo, hi = box_bounds(frame, size_zyx, crop_frame, crop_size_xyz)
    return int(np.prod(hi - lo))
