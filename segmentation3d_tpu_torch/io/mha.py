"""First-party MetaImage (.mha/.mhd) reader/writer, numpy-only.

The reference writes its default segmentation output as ``seg.mha``
(``core/seg_infer.py`` default ``seg_name='seg.mha'``); this module provides
that format without SimpleITK. Supports inline (.mha) and split (.mhd + raw)
layouts, little-endian data, and zlib-compressed payloads. The port's own
copy of ``segmentation3d_tpu/io/mha.py``.
"""
from __future__ import annotations

import os
import zlib

import numpy as np

from segmentation3d_tpu_torch.ops.geometry import Frame

_MET_TO_NP = {
    "MET_CHAR": np.int8, "MET_UCHAR": np.uint8,
    "MET_SHORT": np.int16, "MET_USHORT": np.uint16,
    "MET_INT": np.int32, "MET_UINT": np.uint32,
    "MET_LONG_LONG": np.int64, "MET_ULONG_LONG": np.uint64,
    "MET_FLOAT": np.float32, "MET_DOUBLE": np.float64,
}
_NP_TO_MET = {np.dtype(v): k for k, v in _MET_TO_NP.items()}


def read_mha(path):
    """Read .mha/.mhd -> (data [z,y,x], Frame)."""
    with open(path, "rb") as f:
        header = {}
        data_start = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: no ElementDataFile key found")
            text = line.decode("latin-1").strip()
            if "=" not in text:
                raise ValueError(f"{path}: malformed header line {text!r}")
            key, val = (s.strip() for s in text.split("=", 1))
            header[key] = val
            if key == "ElementDataFile":
                data_start = f.tell()
                break

        ndims = int(header.get("NDims", 3))
        if ndims != 3:
            raise ValueError(f"{path}: only 3D MetaImages supported, NDims={ndims}")
        nchan = int(header.get("ElementNumberOfChannels", 1))
        if nchan != 1:
            # reading the first 1/nchan of the interleaved samples as a
            # scalar volume would be silently scrambled garbage
            raise ValueError(
                f"{path}: multi-channel MetaImage "
                f"(ElementNumberOfChannels={nchan}) is not a scalar volume")
        dims = [int(v) for v in header["DimSize"].split()]  # (nx, ny, nz)
        dtype = np.dtype(_MET_TO_NP[header["ElementType"]])
        if header.get("BinaryDataByteOrderMSB", "False").lower() == "true":
            dtype = dtype.newbyteorder(">")
        spacing = [float(v) for v in header.get(
            "ElementSpacing", header.get("ElementSize", "1 1 1")).split()]
        origin = [float(v) for v in header.get("Offset", "0 0 0").split()]
        direction = np.array([float(v) for v in header.get(
            "TransformMatrix", "1 0 0 0 1 0 0 0 1").split()]).reshape(3, 3)
        compressed = header.get("CompressedData", "False").lower() == "true"

        datafile = header["ElementDataFile"]
        if datafile == "LOCAL":
            raw = f.read()
        else:
            with open(os.path.join(os.path.dirname(os.path.abspath(path)), datafile), "rb") as df:
                raw = df.read()

    if compressed:
        raw = zlib.decompress(raw)
    count = int(np.prod(dims))
    data = np.frombuffer(raw, dtype=dtype, count=count).reshape(dims[::-1])  # [z,y,x]
    data = np.ascontiguousarray(data.astype(data.dtype.newbyteorder("=")))
    # ITK TransformMatrix is written row-major with ROWS = index-axis direction
    # vectors; our Frame uses columns, so transpose.
    return data, Frame(np.asarray(origin), np.asarray(spacing), direction.T)


def write_mha(path, data, frame: Frame):
    """Write a 3D ``[z,y,x]`` array + Frame as uncompressed MetaImage:
    inline for .mha, header + detached ``<base>.raw`` for .mhd (the ITK
    convention — an .mhd header with LOCAL data is not portable)."""
    data = np.asarray(data)
    if data.ndim != 3:
        raise ValueError(f"write_mha expects 3D [z,y,x], got {data.shape}")
    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    if data.dtype not in _NP_TO_MET:
        data = data.astype(np.float32)
    nz, ny, nx = data.shape
    detached = None
    if str(path).lower().endswith(".mhd"):
        detached = os.path.splitext(os.path.basename(path))[0] + ".raw"
    tm = frame.direction.T.reshape(-1)  # rows = axis direction vectors
    lines = [
        "ObjectType = Image",
        "NDims = 3",
        "BinaryData = True",
        "BinaryDataByteOrderMSB = False",
        "CompressedData = False",
        "TransformMatrix = " + " ".join(f"{v:.10g}" for v in tm),
        "Offset = " + " ".join(f"{v:.10g}" for v in frame.origin),
        "CenterOfRotation = 0 0 0",
        "AnatomicalOrientation = LPS",
        "ElementSpacing = " + " ".join(f"{v:.10g}" for v in frame.spacing),
        f"DimSize = {nx} {ny} {nz}",
        f"ElementType = {_NP_TO_MET[np.dtype(data.dtype)]}",
        f"ElementDataFile = {detached or 'LOCAL'}",
    ]
    # memoryview: no tobytes() copy of the whole volume
    payload = memoryview(np.ascontiguousarray(data)).cast("B")
    with open(path, "wb") as f:
        f.write(("\n".join(lines) + "\n").encode("latin-1"))
        if detached is None:
            f.write(payload)
    if detached is not None:
        with open(os.path.join(os.path.dirname(os.path.abspath(path)),
                               detached), "wb") as f:
            f.write(payload)
