"""Reference-named geometric API (``segmentation3d/utils/image_tools.py``).

The port's own copy of ``segmentation3d_tpu/utils/image_tools.py``: the
reference's free-function surface on top of the port's ops. A
:class:`~segmentation3d_tpu_torch.io.Volume` (``data [z,y,x]`` numpy +
``Frame``) plays the role the reference gives ``SimpleITK.Image``; the
resampling functions run the port's resampler on the CPU and return
volumes of numpy voxels. Tensors are torch tensors in the channels-last
``[D, H, W, C]`` layout.

Functions: ``get_image_frame`` / ``set_image_frame``, ``crop_image``,
``convert_image_to_tensor`` / ``convert_tensor_to_image``, ``resample``,
``resample_spacing``, ``image_partition_by_fixed_size``,
``pick_largest_connected_component``, ``remove_small_connected_component``,
``copy_image``.
"""
from __future__ import annotations

import numpy as np
import torch

from segmentation3d_tpu_torch.io import Volume
from segmentation3d_tpu_torch.ops import geometry, resample as _rs
from segmentation3d_tpu_torch.ops.components import (  # noqa: F401 (re-export)
    pick_largest_connected_component, remove_small_connected_component,
)
from segmentation3d_tpu_torch.ops.geometry import Frame


def _cpu_tensor(data) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(data))


def get_image_frame(vol: Volume) -> Frame:
    return vol.frame


def set_image_frame(vol: Volume, frame: Frame) -> Volume:
    vol.frame = frame
    return vol


def crop_image(vol: Volume, center_world, crop_size_xyz, crop_spacing_xyz,
               interpolation: str = "LINEAR", fill: float = 0.0) -> Volume:
    """Fixed-spacing crop centered on a physical point."""
    data, frame = _rs.crop_at_world_center(
        _cpu_tensor(vol.data), vol.frame, center_world, crop_size_xyz,
        crop_spacing_xyz, interp=interpolation, fill=fill)
    return Volume(data.numpy(), frame)


def resample(vol: Volume, target_frame: Frame, target_size_xyz,
             interpolation: str = "LINEAR", fill: float = 0.0) -> Volume:
    """Resample onto an arbitrary target frame/grid."""
    data = _rs.resample_to_frame(_cpu_tensor(vol.data), vol.frame, target_frame,
                                 target_size_xyz, interp=interpolation, fill=fill)
    return Volume(data.numpy(), target_frame)


def resample_spacing(vol: Volume, spacing_xyz, max_stride: int = 1,
                     interpolation: str = "LINEAR", fill: float = 0.0) -> Volume:
    """Whole-volume resample to fixed spacing, dims padded to x ``max_stride``."""
    frame, size = geometry.resampled_frame(vol.frame, vol.size_xyz, spacing_xyz,
                                           max_stride)
    return resample(vol, frame, size, interpolation=interpolation, fill=fill)


def image_partition_by_fixed_size(vol: Volume, partition_size_xyz,
                                  partition_stride_xyz, max_stride: int = 1):
    """Overlapping sliding-window boxes; returns list of (start_xyz, end_xyz)."""
    size = np.asarray(partition_size_xyz, np.int64)
    if max_stride > 1:
        size = (np.ceil(size / max_stride) * max_stride).astype(np.int64)
    starts = geometry.partition_boxes(vol.size_xyz, size, partition_stride_xyz)
    return [(s, s + size) for s in starts]


def convert_image_to_tensor(vol_or_list) -> torch.Tensor:
    """Volume(s) -> a channels-last tensor ``[D,H,W,C]`` (a list of
    equal-shape volumes stacks its volumes as the channels)."""
    if isinstance(vol_or_list, (list, tuple)):
        return torch.stack([torch.tensor(v.data) for v in vol_or_list], dim=-1)
    return torch.tensor(vol_or_list.data)[..., None]


def convert_tensor_to_image(tensor, frame: Frame, dtype=None):
    """Channels-last tensor -> Volume(s) (one per channel if C > 1)."""
    arr = tensor.detach().cpu().numpy() if isinstance(tensor, torch.Tensor) \
        else np.asarray(tensor)
    if arr.ndim == 4:
        vols = [Volume(arr[..., c].astype(dtype) if dtype else arr[..., c], frame)
                for c in range(arr.shape[-1])]
        return vols[0] if len(vols) == 1 else vols
    return Volume(arr.astype(dtype) if dtype else arr, frame)


def copy_image(vol: Volume) -> Volume:
    return Volume(np.array(vol.data, copy=True), vol.frame)
