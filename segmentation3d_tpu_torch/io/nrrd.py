"""First-party NRRD (.nrrd/.nhdr) reader/writer, numpy-only.

The reference reads inputs through ``sitk.ReadImage`` (SURVEY.md C7/C11),
which accepts NRRD — the native format of 3D Slicer and a very common
interchange format for segmentation ground truth. This module provides the
same capability without SimpleITK: NRRD0001-0005 headers, raw / gzip / ascii
encodings, attached (.nrrd) and detached (.nhdr + data file) layouts, and
LPS/RAS/LAS anatomical spaces (non-LPS spaces are converted to the LPS world
frame used everywhere else, matching ITK's behavior). The port's own copy of
``segmentation3d_tpu/io/nrrd.py``; gzip goes through ``io/nifti.py``'s
one-shot path (libdeflate when the native codec loaded, else zlib).
"""
from __future__ import annotations

import os
import re
import zlib

import numpy as np

from segmentation3d_tpu_torch.io.nifti import gunzip, gzip_bytes
from segmentation3d_tpu_torch.ops.geometry import Frame

# NRRD type aliases -> numpy dtype (little set; covers everything medical)
_TYPE_TO_NP = {
    "signed char": np.int8, "int8": np.int8, "int8_t": np.int8,
    "uchar": np.uint8, "unsigned char": np.uint8, "uint8": np.uint8,
    "uint8_t": np.uint8,
    "short": np.int16, "short int": np.int16, "signed short": np.int16,
    "signed short int": np.int16, "int16": np.int16, "int16_t": np.int16,
    "ushort": np.uint16, "unsigned short": np.uint16,
    "unsigned short int": np.uint16, "uint16": np.uint16, "uint16_t": np.uint16,
    "int": np.int32, "signed int": np.int32, "int32": np.int32,
    "int32_t": np.int32,
    "uint": np.uint32, "unsigned int": np.uint32, "uint32": np.uint32,
    "uint32_t": np.uint32,
    "longlong": np.int64, "long long": np.int64, "long long int": np.int64,
    "signed long long": np.int64, "int64": np.int64, "int64_t": np.int64,
    "ulonglong": np.uint64, "unsigned long long": np.uint64,
    "uint64": np.uint64, "uint64_t": np.uint64,
    "float": np.float32, "double": np.float64,
}
_NP_TO_TYPE = {
    np.dtype(np.int8): "int8", np.dtype(np.uint8): "uint8",
    np.dtype(np.int16): "int16", np.dtype(np.uint16): "uint16",
    np.dtype(np.int32): "int32", np.dtype(np.uint32): "uint32",
    np.dtype(np.int64): "int64", np.dtype(np.uint64): "uint64",
    np.dtype(np.float32): "float", np.dtype(np.float64): "double",
}

# world-frame sign flips that bring a named space into LPS (x, y, z)
_SPACE_TO_LPS_FLIP = {
    "left-posterior-superior": (1.0, 1.0, 1.0), "lps": (1.0, 1.0, 1.0),
    "right-anterior-superior": (-1.0, -1.0, 1.0), "ras": (-1.0, -1.0, 1.0),
    "left-anterior-superior": (1.0, -1.0, 1.0), "las": (1.0, -1.0, 1.0),
    "right-posterior-superior": (-1.0, 1.0, 1.0), "rps": (-1.0, 1.0, 1.0),
    # a bare 3-D scalar space (no anatomy): take it as-is
    "3d-right-handed": (1.0, 1.0, 1.0), "3d-left-handed": (1.0, 1.0, 1.0),
}


def _parse_vector(text: str) -> np.ndarray:
    """'(a, b, c)' -> float array (3,)."""
    inner = text.strip().lstrip("(").rstrip(")")
    return np.array([float(v) for v in re.split(r"[,\s]+", inner.strip()) if v])


def _parse_header(f, path):
    magic = f.readline()
    if not magic.startswith(b"NRRD"):
        raise ValueError(f"{path}: not a NRRD file (magic {magic[:8]!r})")
    fields = {}
    while True:
        line = f.readline()
        if line in (b"\n", b"\r\n", b""):  # blank line = end of header
            break
        text = line.decode("utf-8", "replace").rstrip("\r\n")
        if text.startswith("#"):
            continue
        if ":=" in text:  # key/value metadata — not needed for geometry
            continue
        if ":" not in text:
            raise ValueError(f"{path}: malformed NRRD header line {text!r}")
        key, val = text.split(":", 1)
        key = key.strip().lower()
        fields[key] = val.strip()
        if key in ("data file", "datafile") and \
                fields[key].split()[:1] == ["LIST"]:
            break  # the remaining header lines are the per-file list
    return fields


def _decode(raw: bytes, encoding: str, dtype, count: int, path) -> np.ndarray:
    if encoding in ("raw",):
        return np.frombuffer(raw, dtype=dtype, count=count)
    if encoding in ("gzip", "gz"):
        # a gzip container, or a bare zlib stream (some writers)
        raw = gunzip(raw) if raw[:2] == b"\x1f\x8b" else zlib.decompress(raw)
        return np.frombuffer(raw, dtype=dtype, count=count)
    if encoding in ("ascii", "txt", "text"):
        return np.array(raw.split(), dtype=np.dtype(dtype).newbyteorder("="))[:count]
    raise ValueError(f"{path}: unsupported NRRD encoding {encoding!r} "
                     "(raw, gzip, ascii supported)")


def read_nrrd(path):
    """Read .nrrd/.nhdr -> (data [z,y,x], Frame in LPS)."""
    with open(path, "rb") as f:
        fields = _parse_header(f, path)
        datafile = fields.get("data file", fields.get("datafile"))
        if datafile is None:
            raw = f.read()
        else:
            # multi-file forms: "LIST [<subdim>]" or a printf-style
            # "<format> <min> <max> <step> [<subdim>]" (contains %).
            # A plain filename may legitimately contain spaces.
            if datafile.split()[0].upper() == "LIST" or "%" in datafile:
                raise ValueError(f"{path}: multi-file NRRD data is not supported")
            dpath = os.path.join(os.path.dirname(os.path.abspath(path)), datafile)
            with open(dpath, "rb") as df:
                raw = df.read()

    dim = int(fields.get("dimension", 3))
    if dim != 3:
        raise ValueError(f"{path}: only 3D NRRD supported, dimension={dim}")
    sizes = [int(v) for v in fields["sizes"].split()]  # fastest axis first: nx ny nz
    tname = fields.get("type", "").lower().strip()
    if tname not in _TYPE_TO_NP:
        raise ValueError(f"{path}: unsupported NRRD type {tname!r}")
    dtype = np.dtype(_TYPE_TO_NP[tname])
    if dtype.itemsize > 1 and fields.get("endian", "little").lower() == "big":
        dtype = dtype.newbyteorder(">")

    encoding = fields.get("encoding", "raw").lower()
    lskip = int(fields.get("line skip", fields.get("lineskip", 0)))
    if lskip > 0:  # spec: skip N text lines of the data (file), THEN bytes
        pos = 0
        for _ in range(lskip):
            nl = raw.find(b"\n", pos)
            if nl < 0:
                raise ValueError(f"{path}: line skip {lskip} exceeds data")
            pos = nl + 1
        raw = raw[pos:]
    elif lskip < 0:
        raise ValueError(f"{path}: negative line skip {lskip}")
    skip = int(fields.get("byte skip", fields.get("byteskip", 0)))
    count = int(np.prod(sizes))
    if skip == -1:  # raw-only convention: data is the LAST count*itemsize bytes
        if encoding != "raw":
            raise ValueError(f"{path}: byte skip -1 is only valid for raw encoding")
        raw = raw[len(raw) - count * dtype.itemsize:]
    elif skip > 0:
        raw = raw[skip:]
    data = _decode(raw, encoding, dtype, count, path)
    if data.size < count:
        raise ValueError(f"{path}: NRRD payload too short "
                         f"({data.size} of {count} samples)")
    data = data.reshape(sizes[::-1])  # [z,y,x]
    data = np.ascontiguousarray(data.astype(data.dtype.newbyteorder("=")))

    # ---- geometry ----
    space = fields.get("space", "").lower().strip()
    flip = np.array(_SPACE_TO_LPS_FLIP.get(space, (1.0, 1.0, 1.0)))
    if space and space not in _SPACE_TO_LPS_FLIP:
        raise ValueError(f"{path}: unsupported NRRD space {space!r}")
    if "space directions" in fields:
        vecs = re.findall(r"\(([^)]*)\)|(none)", fields["space directions"])
        cols = []
        for grp, none_tok in vecs:
            if none_tok:
                raise ValueError(f"{path}: non-spatial 'none' axis in a 3D NRRD")
            cols.append(_parse_vector(f"({grp})"))
        if len(cols) != 3:
            raise ValueError(f"{path}: expected 3 space directions, got {len(cols)}")
        # vector i is the world step of index axis i -> column i of dir*spacing
        m = np.stack(cols, axis=1) * flip[:, None]
        spacing = np.linalg.norm(m, axis=0)
        if np.any(spacing == 0):
            raise ValueError(f"{path}: zero-length space direction")
        direction = m / spacing[None, :]
    else:
        spacing = np.array([float(v) for v in fields.get(
            "spacings", "1 1 1").split()])
        direction = np.eye(3)
    if "space origin" in fields:
        origin = _parse_vector(fields["space origin"]) * flip
    else:
        origin = np.zeros(3)
    return data, Frame(origin, spacing, direction)


def write_nrrd(path, data, frame: Frame, compress: bool | None = None):
    """Write a 3D ``[z,y,x]`` array + LPS Frame as NRRD.

    ``.nrrd`` -> attached single file; ``.nhdr`` -> detached header + a
    sibling raw data file. ``compress`` defaults to True for .nrrd (gzip
    level 1, same choice as io/nifti.py) and False (raw) for .nhdr.
    """
    data = np.asarray(data)
    if data.ndim != 3:
        raise ValueError(f"write_nrrd expects 3D [z,y,x], got {data.shape}")
    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    if data.dtype not in _NP_TO_TYPE:
        data = data.astype(np.float32)
    detached = str(path).lower().endswith(".nhdr")
    if compress is None:
        compress = not detached
    nz, ny, nx = data.shape
    dirs = frame.direction * frame.spacing[None, :]  # column i = axis-i step
    vec = lambda v: "(" + ",".join(f"{x:.10g}" for x in v) + ")"
    lines = [
        "NRRD0004",
        "# written by segmentation3d_tpu_torch",
        f"type: {_NP_TO_TYPE[np.dtype(data.dtype)]}",
        "dimension: 3",
        "space: left-posterior-superior",
        f"sizes: {nx} {ny} {nz}",
        "space directions: " + " ".join(vec(dirs[:, i]) for i in range(3)),
        "kinds: domain domain domain",
        "endian: little",
        f"encoding: {'gzip' if compress else 'raw'}",
        "space origin: " + vec(frame.origin),
    ]
    payload = memoryview(np.ascontiguousarray(
        data.astype(data.dtype.newbyteorder("<")))).cast("B")
    if compress:
        # gzip container (what teem/Slicer write); level 1 as in io/nifti.py
        payload = gzip_bytes(payload, 1)
    if detached:
        dataname = os.path.basename(str(path))[:-5] + (".raw.gz" if compress else ".raw")
        lines.append(f"data file: {dataname}")
        with open(os.path.join(os.path.dirname(os.path.abspath(str(path))), dataname), "wb") as df:
            df.write(payload)
        with open(path, "wb") as f:
            f.write(("\n".join(lines) + "\n").encode("utf-8"))
    else:
        with open(path, "wb") as f:
            f.write(("\n".join(lines) + "\n\n").encode("utf-8"))
            f.write(payload)
