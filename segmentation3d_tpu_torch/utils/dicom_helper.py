"""Reference-named DICOM facade: read/write a DICOM series as a
:class:`~segmentation3d_tpu_torch.io.volume.Volume`.

The parser and writer live in :mod:`segmentation3d_tpu_torch.io.dicom`. The
port's own copy of ``segmentation3d_tpu/utils/dicom_helper.py``.
"""
from __future__ import annotations

import numpy as np

from segmentation3d_tpu_torch.io import Volume
from segmentation3d_tpu_torch.io.dicom import read_dicom_series as _read
from segmentation3d_tpu_torch.io.dicom import write_dicom_series as _write


def read_dicom_series(folder: str) -> Volume:
    """Read all DICOM slices in ``folder`` into one volume."""
    data, frame = _read(folder)
    return Volume(data, frame)


def write_dicom_series(vol: Volume, folder: str, series_uid: str | None = None):
    """Write a volume as one explicit-VR-LE DICOM file per slice."""
    return _write(folder, np.asarray(vol.data), vol.frame, series_uid=series_uid)
