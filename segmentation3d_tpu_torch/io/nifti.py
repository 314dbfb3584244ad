"""First-party NIfTI-1 + Analyze 7.5 reader/writer, numpy-only.

Covers ``.nii`` / ``.nii.gz`` single files and the two-file ``.hdr``/``.img``
pair family (NIfTI-1 "ni1" pairs and plain Analyze 7.5 headers).

Replaces the reference's SimpleITK ``ReadImage``/``WriteImage`` for NIfTI
(``utils/image_tools.py`` usage throughout). Supports the scalar 3D volumes
the toolkit works with; data returned as ``[z, y, x]`` C-order arrays plus an
ITK-convention (LPS) :class:`~segmentation3d_tpu_torch.ops.geometry.Frame`.

NIfTI affines are RAS; ITK frames are LPS — we convert with the standard
``diag(-1,-1,1)`` flip so .nii and .mha round-trips agree. The port's own
copy of ``segmentation3d_tpu/io/nifti.py``; ``.gz`` goes through zlib.
"""
from __future__ import annotations

import gzip
import os
import struct
import zlib

import numpy as np

from segmentation3d_tpu_torch.ops.geometry import Frame

_RAS2LPS = np.diag([-1.0, -1.0, 1.0])

# NIfTI datatype codes
_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32,
    64: np.float64, 256: np.int8, 512: np.uint16, 768: np.uint32,
    1024: np.int64, 1280: np.uint64,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


# gzip's default compresslevel is 9: seconds per written volume for <1%
# size over level 1 on segmentation masks (long runs of equal labels)
_GZIP_LEVEL = 1


class _OneShotGzipWriter:
    """File-like ``.gz`` writer that buffers the payload (zero-copy: the
    memoryviews keep their exporters alive) and compresses it in ONE pass
    at close, so an error mid-write leaves no truncated ``.gz`` behind."""

    def __init__(self, path, level):
        self._path = path
        self._level = level
        self._parts = []
        self.closed = False

    def write(self, b):
        self._parts.append(memoryview(b).cast("B"))
        return len(self._parts[-1])

    def close(self):
        if self.closed:
            return
        self.closed = True
        blob = gzip.compress(b"".join(self._parts), compresslevel=self._level)
        with open(self._path, "wb") as f:
            f.write(blob)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:  # do not write a truncated .gz on error
            self.close()
        return False


def _open(path, mode="rb"):
    if str(path).endswith(".gz"):
        if "w" in mode:
            return _OneShotGzipWriter(path, _GZIP_LEVEL)
        return gzip.open(path, mode)
    return open(path, mode)


def _read_bytes(path) -> bytes:
    """Whole file -> decompressed bytes. For .gz this is a one-shot zlib
    decompress of the full compressed blob (faster than ``gzip.open``'s
    chunked stream), member by member."""
    with open(path, "rb") as f:
        raw = f.read()
    if not str(path).endswith(".gz"):
        return raw
    out = []
    while raw:
        d = zlib.decompressobj(wbits=31)
        out.append(d.decompress(raw))
        out.append(d.flush())
        if not d.eof:
            break  # truncated member: return what decoded; frombuffer errors
        raw = d.unused_data  # multi-member .gz: keep going
    return out[0] if len(out) == 1 else b"".join(out)


class _Hdr:
    """Parsed 348-byte NIfTI-1 / Analyze 7.5 header (field subset we use)."""

    def __init__(self, hdr: bytes, path):
        if len(hdr) < 348:
            raise ValueError(f"{path}: truncated NIfTI/Analyze header")
        sizeof_hdr = struct.unpack("<i", hdr[0:4])[0]
        endian = "<"
        if sizeof_hdr != 348:
            sizeof_hdr = struct.unpack(">i", hdr[0:4])[0]
            if sizeof_hdr != 348:
                raise ValueError(f"{path}: not a NIfTI-1/Analyze file")
            endian = ">"
        self.endian = endian
        self.magic = hdr[344:348]
        # b"n+1\0" = single file, b"ni1\0" = .hdr/.img pair, anything else
        # (usually zeros) = plain Analyze 7.5
        self.is_nifti = self.magic[:2] in (b"n+", b"ni")
        dim = struct.unpack(endian + "8h", hdr[40:56])
        ndim = dim[0]
        if not 1 <= ndim <= 7:
            raise ValueError(f"{path}: bad header dim[0]={ndim}")
        self.shape_fortran = [max(1, d) for d in dim[1:1 + ndim]]
        self.datatype = struct.unpack(endian + "h", hdr[70:72])[0]
        bitpix = struct.unpack(endian + "h", hdr[72:74])[0]
        self.pixdim = struct.unpack(endian + "8f", hdr[76:108])
        self.vox_offset = struct.unpack(endian + "f", hdr[108:112])[0]
        if self.is_nifti:
            self.scl_slope = struct.unpack(endian + "f", hdr[112:116])[0]
            self.scl_inter = struct.unpack(endian + "f", hdr[116:120])[0]
            self.qform_code = struct.unpack(endian + "h", hdr[252:254])[0]
            self.sform_code = struct.unpack(endian + "h", hdr[254:256])[0]
            self.quats = struct.unpack(endian + "6f", hdr[256:280])
            self.srow = np.array(
                struct.unpack(endian + "12f", hdr[280:328])).reshape(3, 4)
        else:
            # Analyze 7.5: those bytes are funused/descrip fields. SPM abuses
            # funused1 as a scale factor but ITK ignores it; so do we.
            self.scl_slope, self.scl_inter = 1.0, 0.0
            self.qform_code = self.sform_code = 0
            self.quats, self.srow = None, None
        if self.datatype not in _DTYPES:
            raise ValueError(
                f"{path}: unsupported NIfTI/Analyze datatype {self.datatype}")
        self.dtype = np.dtype(_DTYPES[self.datatype]).newbyteorder(endian)
        if self.dtype.itemsize * 8 != bitpix:
            raise ValueError(
                f"{path}: bitpix {bitpix} mismatches datatype {self.datatype}")

    def read_data_bytes(self, raw: bytes, path, offset=None) -> np.ndarray:
        """Pixel block from an in-memory buffer -> C-order [z,y,x] array.

        Native-endian data stays a ZERO-COPY (read-only) view of ``raw`` —
        nothing downstream mutates volume voxels in place, and the old
        unconditional astype copied 113 MB per 384^3 case for nothing."""
        off = int(self.vox_offset if offset is None else offset)
        count = int(np.prod(self.shape_fortran))
        data = np.frombuffer(raw, dtype=self.dtype, count=count, offset=off)
        # Fortran order on disk (i fastest) -> C array indexed [..., k, j, i]
        data = data.reshape(self.shape_fortran[::-1])
        # squeeze trailing singleton time/vector dims down to 3D if possible
        while data.ndim > 3 and data.shape[0] == 1:
            data = data[0]
        if not data.dtype.isnative:
            data = np.ascontiguousarray(
                data.astype(data.dtype.newbyteorder("=")))
        # a zero/non-finite slope means "no scaling AT ALL" (nibabel
        # semantics: an invalid slope invalidates the whole scl transform,
        # so the intercept is ignored too — applying inter with an implied
        # slope of 1 would shift the volume silently)
        slope = self.scl_slope if np.isfinite(self.scl_slope) else 0.0
        inter = self.scl_inter if np.isfinite(self.scl_inter) else 0.0
        if slope != 0.0 and (slope != 1.0 or inter != 0.0):
            data = data.astype(np.float32) * slope + inter
        return data

    def frame(self) -> Frame:
        """LPS frame: sform, then qform, then pixdim-only (Analyze)."""
        if not self.is_nifti:
            # plain Analyze 7.5 has no affine and no RAS convention to flip:
            # pixdim spacing, identity direction, origin 0 (the reference's
            # SimpleITK behavior for legacy Analyze files)
            sp = np.array([self.pixdim[1] or 1.0, self.pixdim[2] or 1.0,
                           self.pixdim[3] or 1.0])
            return Frame(np.zeros(3), sp, np.eye(3))
        if self.sform_code > 0:
            aff_ras = np.eye(4)
            aff_ras[:3, :] = self.srow
        elif self.qform_code > 0:
            aff_ras = _qform_affine(self.quats, self.pixdim)
        else:
            aff_ras = np.diag([self.pixdim[1] or 1.0, self.pixdim[2] or 1.0,
                               self.pixdim[3] or 1.0, 1.0])
        m_lps = _RAS2LPS @ aff_ras[:3, :3]
        origin = _RAS2LPS @ aff_ras[:3, 3]
        spacing = np.linalg.norm(m_lps, axis=0)
        spacing[spacing == 0] = 1.0
        direction = m_lps / spacing
        return Frame(origin, spacing, direction)


def read_nifti(path):
    """Read a .nii/.nii.gz file -> (data [z,y,x] (or [...,t] squeezed), Frame)."""
    raw = _read_bytes(path)
    h = _Hdr(raw[:348], path)
    if not h.is_nifti:
        raise ValueError(f"{path}: bad NIfTI magic {h.magic!r}")
    if h.magic[:2] == b"ni":
        raise ValueError(
            f"{path}: two-file NIfTI pair header — read the .hdr via "
            "read_hdr_img")
    return h.read_data_bytes(raw, path), h.frame()


def _pair_paths(path):
    """(.hdr path, .img path) for any of .hdr/.img/.img.gz inputs. An
    explicitly named data file (.img or .img.gz) is used VERBATIM — if both
    exist next to each other, the caller gets the one they asked for, never
    a silently different sibling; only a .hdr input auto-resolves the data
    side (.img, falling back to .img.gz)."""
    p = str(path)
    low = p.lower()
    if low.endswith(".hdr"):
        base = p[:-4]
        img_path = base + ".img"
        if not os.path.exists(img_path) and os.path.exists(img_path + ".gz"):
            img_path += ".gz"
    elif low.endswith(".img.gz"):
        base, img_path = p[:-7], p
    elif low.endswith(".img"):
        base, img_path = p[:-4], p
    else:
        raise ValueError(f"not an Analyze pair path: {path}")
    return base + ".hdr", img_path


def read_hdr_img(path):
    """Read a two-file .hdr/.img volume (NIfTI-1 "ni1" pair or plain Analyze
    7.5) -> (data [z,y,x], Frame). ``path`` may name either file; a
    gzip-compressed ``.img.gz`` data file is found automatically.

    Plain Analyze headers carry no orientation/origin (the SPM originator
    convention is nonstandard and ITK ignores it) — those get spacing from
    pixdim with identity direction and origin 0, like the reference's
    SimpleITK reader."""
    hdr_path, img_path = _pair_paths(path)
    with _open(hdr_path, "rb") as f:
        h = _Hdr(f.read(348), hdr_path)
    if h.magic[:2] == b"n+":
        raise ValueError(f"{hdr_path}: single-file NIfTI magic in a .hdr")
    if not os.path.exists(img_path):
        raise FileNotFoundError(f"{hdr_path}: data file {img_path} not found")
    # data starts at 0 in the .img file; vox_offset is for single-file
    data = h.read_data_bytes(_read_bytes(img_path), img_path, offset=0)
    return data, h.frame()


def _qform_affine(quats, pixdim):
    b, c, d, qx, qy, qz = quats
    a = float(np.sqrt(max(0.0, 1.0 - (b * b + c * c + d * d))))
    rot = np.array([
        [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
        [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
        [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
    ])
    qfac = -1.0 if pixdim[0] < 0 else 1.0
    sp = np.array([pixdim[1] or 1.0, pixdim[2] or 1.0, qfac * (pixdim[3] or 1.0)])
    aff = np.eye(4)
    aff[:3, :3] = rot * sp
    aff[:3, 3] = (qx, qy, qz)
    return aff


def _build_hdr(data, frame: Frame, magic: bytes, vox_offset: float):
    """348-byte little-endian NIfTI-1 header (sform, RAS) for ``data``."""
    dt = np.dtype(data.dtype)
    m_lps = frame.direction @ np.diag(frame.spacing)
    m_ras = _RAS2LPS @ m_lps
    origin_ras = _RAS2LPS @ frame.origin

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    nz, ny, nx = data.shape
    struct.pack_into("<8h", hdr, 40, 3, nx, ny, nz, 1, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, _CODES[dt])
    struct.pack_into("<h", hdr, 72, dt.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, 1.0,
                     *[float(s) for s in frame.spacing], 1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<f", hdr, 108, vox_offset)
    struct.pack_into("<f", hdr, 112, 1.0)    # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)    # scl_inter
    struct.pack_into("<h", hdr, 252, 0)      # qform_code
    struct.pack_into("<h", hdr, 254, 1)      # sform_code = SCANNER_ANAT
    srow = np.zeros((3, 4), np.float64)
    srow[:, :3] = m_ras
    srow[:, 3] = origin_ras
    struct.pack_into("<12f", hdr, 280, *srow.reshape(-1).astype(np.float32))
    hdr[344:348] = magic
    return bytes(hdr)


def _writable(data) -> np.ndarray:
    data = np.asarray(data)
    if data.ndim != 3:
        raise ValueError(f"expected 3D [z,y,x] volume, got {data.shape}")
    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    if data.dtype not in _CODES:
        data = data.astype(np.float32)
    return data


def write_nifti(path, data, frame: Frame):
    """Write a 3D ``[z,y,x]`` array + LPS Frame as NIfTI-1 (sform, RAS)."""
    data = _writable(data)
    hdr = _build_hdr(data, frame, b"n+1\x00", 352.0)
    with _open(path, "wb") as f:
        f.write(hdr)
        f.write(b"\x00" * 4)  # extension flag padding to vox_offset 352
        # memoryview: no tobytes() copy of the whole volume
        f.write(memoryview(np.ascontiguousarray(data)).cast("B"))


def write_hdr_img(path, data, frame: Frame):
    """Write a two-file .hdr/.img pair (NIfTI-1 "ni1" header, so orientation
    survives — the same flavor ITK's NiftiImageIO emits for .hdr paths;
    plain-Analyze consumers still read it as Analyze since the layout is
    identical). ``path`` may name the .hdr, .img, or .img.gz side; naming
    ``.img.gz`` gzips the data file."""
    data = _writable(data)
    p = str(path)
    gz_img = p.lower().endswith(".img.gz")
    if p.lower().endswith(".hdr"):
        base = p[:-4]
    elif gz_img:
        base = p[:-7]
    elif p.lower().endswith(".img"):
        base = p[:-4]
    else:
        raise ValueError(f"not an Analyze pair path: {path}")
    hdr = _build_hdr(data, frame, b"ni1\x00", 0.0)
    with open(base + ".hdr", "wb") as f:
        f.write(hdr)
    with _open(base + (".img.gz" if gz_img else ".img"), "wb") as f:
        f.write(memoryview(np.ascontiguousarray(data)).cast("B"))
