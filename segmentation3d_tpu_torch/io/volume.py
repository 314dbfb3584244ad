"""Volume container + format-dispatching read/write.

Replaces the reference's ``sitk.ReadImage``/``sitk.WriteImage`` call sites
and the sitk<->tensor conversions (``utils/image_tools.py``:
``convert_image_to_tensor``/``convert_tensor_to_image`` ≈L95-140): here a
volume is simply a numpy ``[z,y,x]`` array paired with a
:class:`~segmentation3d_tpu_torch.ops.geometry.Frame`. Voxel data stays in
numpy on the host; it is converted to float32 before it reaches the device
(torch's uint16/int16 support is patchy). The port's own copy of
``segmentation3d_tpu/io/volume.py``, for NIfTI (.nii, .nii.gz, .hdr/.img)
and MetaImage (.mha, .mhd).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from segmentation3d_tpu_torch.io import mha, nifti
from segmentation3d_tpu_torch.ops.geometry import Frame


@dataclasses.dataclass
class Volume:
    """A 3D scalar volume: ``data`` indexed [z,y,x] + physical ``frame``."""

    data: np.ndarray
    frame: Frame

    @property
    def size_xyz(self) -> np.ndarray:
        """Voxel counts in (nx, ny, nz) order (ITK GetSize convention)."""
        return np.asarray(self.data.shape[::-1], np.int64)


_NIFTI_EXTS = (".nii", ".nii.gz")
_MHA_EXTS = (".mha", ".mhd")
# two-file pairs: NIfTI-1 "ni1" or plain Analyze 7.5 headers (io.nifti)
_PAIR_EXTS = (".hdr", ".img", ".img.gz")
# formats the JAX package reads that this port does not yet
_NOT_PORTED = (".nrrd", ".nhdr")


def _ext(path: str) -> str:
    p = str(path).lower()
    for multi in (".nii.gz", ".img.gz"):
        if p.endswith(multi):
            return multi
    return os.path.splitext(p)[1]


def read_image(path, dtype=None) -> Volume:
    """Read a volume from .nii/.nii.gz/.hdr/.img/.mha/.mhd."""
    ext = _ext(path)
    if ext in _NIFTI_EXTS:
        data, frame = nifti.read_nifti(path)
    elif ext in _MHA_EXTS:
        data, frame = mha.read_mha(path)
    elif ext in _PAIR_EXTS:
        data, frame = nifti.read_hdr_img(path)
    elif ext in _NOT_PORTED or os.path.isdir(path):
        raise NotImplementedError(
            f"{path}: NRRD and DICOM input are not ported yet")
    else:
        raise ValueError(f"unsupported image format: {path}")
    if dtype is not None:
        data = data.astype(dtype)
    return Volume(data, frame)


def write_image(vol: Volume, path) -> None:
    ext = _ext(path)
    d = os.path.dirname(os.path.abspath(str(path)))
    os.makedirs(d, exist_ok=True)
    if ext in _NIFTI_EXTS:
        nifti.write_nifti(path, vol.data, vol.frame)
    elif ext in _MHA_EXTS:
        mha.write_mha(path, vol.data, vol.frame)
    elif ext in _PAIR_EXTS:
        nifti.write_hdr_img(path, vol.data, vol.frame)
    elif ext in _NOT_PORTED:
        raise NotImplementedError(f"{path}: NRRD output is not ported yet")
    else:
        raise ValueError(f"unsupported image format: {path}")
