"""Minimal DICOM series reader + writer (CT/MR volumes), numpy-only.

Covers the reference's ``utils/dicom_helper.py`` capability (SURVEY.md C15
[L], "read/write DICOM series"): read a folder of single-frame DICOM slices
into one volume + frame, and write a volume back out as an explicit-VR-LE
secondary-capture series (one file per slice, int16 pixels with rescale
slope/intercept).

Supported reading: DICM part-10 files, explicit/implicit VR little endian,
native PixelData, RLE Lossless and JPEG Lossless (.57 / .70), MONOCHROME
photometric interpretation. Slices are sorted by ImagePositionPatient along
the slice normal; rescale slope/intercept applied. Lossy JPEG families raise
a clear error.

The port's own copy of ``segmentation3d_tpu/io/dicom.py``. Unlike it, a
multi-frame file (NumberOfFrames (0028,0008) > 1) gives every frame, stepped
along the slice normal by SpacingBetweenSlices (0018,0088), and a JPEG
Lossless sample that does not fit BitsAllocated raises instead of wrapping.
"""
from __future__ import annotations

import os
import struct

import numpy as np

from segmentation3d_tpu_torch.io.jpeg_lossless import (
    decode_jpeg_lossless, encode_jpeg_lossless)
from segmentation3d_tpu_torch.ops.geometry import Frame

# (group, element) tags
TAG_TRANSFER_SYNTAX = (0x0002, 0x0010)
TAG_ROWS = (0x0028, 0x0010)
TAG_COLS = (0x0028, 0x0011)
TAG_BITS_ALLOC = (0x0028, 0x0100)
TAG_PIXEL_REPR = (0x0028, 0x0103)
TAG_SPACING = (0x0028, 0x0030)
TAG_POSITION = (0x0020, 0x0032)
TAG_ORIENTATION = (0x0020, 0x0037)
TAG_SLOPE = (0x0028, 0x1053)
TAG_INTERCEPT = (0x0028, 0x1052)
TAG_PIXEL_DATA = (0x7FE0, 0x0010)
TAG_SERIES_UID = (0x0020, 0x000E)
TAG_INSTANCE_NUMBER = (0x0020, 0x0013)
TAG_NUM_FRAMES = (0x0028, 0x0008)
TAG_SLICE_SPACING = (0x0018, 0x0088)

_EXPLICIT_LONG_VRS = {b"OB", b"OW", b"OF", b"SQ", b"UT", b"UN", b"OD", b"OL", b"UC", b"UR"}
_UNCOMPRESSED = {
    "1.2.840.10008.1.2",        # implicit VR LE
    "1.2.840.10008.1.2.1",      # explicit VR LE
}
_RLE_LOSSLESS = "1.2.840.10008.1.2.5"   # PS3.5 Annex G (PackBits segments)
# JPEG Lossless, Non-Hierarchical (T.81 process 14) — first-party codec in
# io/jpeg_lossless.py: .57 = any predictor, .70 = first-order prediction
# (SV1), the common archival syntax
_JPEG_LOSSLESS = {"1.2.840.10008.1.2.4.57", "1.2.840.10008.1.2.4.70"}
_JPEG_LOSSLESS_SV1 = "1.2.840.10008.1.2.4.70"
_SUPPORTED = _UNCOMPRESSED | {_RLE_LOSSLESS} | _JPEG_LOSSLESS


class _Encapsulated(list):
    """Encapsulated PixelData: the fragments (a list) and ``bot``, the Basic
    Offset Table's bytes (empty when the writer left it empty)."""

    def __init__(self, bot, fragments):
        super().__init__(fragments)
        self.bot = bot

    def frames(self, nframes):
        """The compressed bytes of each of ``nframes`` frames: all fragments
        for one frame, else one fragment per frame, else split where the
        Basic Offset Table says each frame's first fragment starts."""
        if nframes == 1:
            return [b"".join(self)]
        if len(self) == nframes:
            return list(self)
        offsets = list(struct.unpack(f"<{len(self.bot) // 4}I", self.bot))
        if len(offsets) != nframes:
            raise ValueError(
                f"{len(self)} PixelData fragments for {nframes} frames and "
                f"{len(offsets)} Basic Offset Table entries")
        starts, pos = [], 0  # each fragment's offset from the first item
        for frag in self:
            starts.append(pos)
            pos += 8 + len(frag)
        if not all(o in starts for o in offsets) or offsets != sorted(offsets):
            raise ValueError("Basic Offset Table entries do not start fragments")
        first = [starts.index(o) for o in offsets] + [len(self)]
        return [b"".join(self[first[k]:first[k + 1]]) for k in range(nframes)]


def _parse_elements(buf: bytes, start: int, explicit: bool, stop_tag=TAG_PIXEL_DATA):
    """Yield ((group, elem), value_bytes); stops after pixel data.

    Encapsulated (undefined-length) PixelData — the container compressed
    transfer syntaxes use — yields an :class:`_Encapsulated` (the Basic
    Offset Table and the fragments); any other undefined-length element
    still raises."""
    pos = start
    n = len(buf)
    while pos + 8 <= n:
        group, elem = struct.unpack_from("<HH", buf, pos)
        pos += 4
        if explicit and group != 0xFFFE:
            vr = buf[pos:pos + 2]
            if vr in _EXPLICIT_LONG_VRS:
                length = struct.unpack_from("<I", buf, pos + 4)[0]
                pos += 8
            else:
                length = struct.unpack_from("<H", buf, pos + 2)[0]
                pos += 4
        else:
            length = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        if length == 0xFFFFFFFF:
            if (group, elem) != TAG_PIXEL_DATA:
                raise ValueError(
                    "undefined-length (sequence) element not supported by "
                    "the minimal DICOM reader")
            frames = []
            bot = None  # the first item is the Basic Offset Table
            closed = False
            while pos + 8 <= n:
                ig, ie = struct.unpack_from("<HH", buf, pos)
                ilen = struct.unpack_from("<I", buf, pos + 4)[0]
                pos += 8
                if (ig, ie) == (0xFFFE, 0xE0DD):  # sequence delimiter
                    closed = True
                    break
                if (ig, ie) != (0xFFFE, 0xE000):
                    raise ValueError("malformed encapsulated PixelData item")
                if pos + ilen > n:
                    raise ValueError(
                        "truncated encapsulated PixelData item (runs past "
                        "end of file)")
                item = buf[pos:pos + ilen]
                pos += ilen
                if bot is None:
                    bot = item
                else:
                    frames.append(item)
            if not closed:
                # loud failure, matching the rest of the reader: a file cut
                # off before the (FFFE,E0DD) sequence delimiter must not be
                # accepted just because its last complete fragment decodes
                raise ValueError(
                    "truncated encapsulated PixelData: sequence delimiter "
                    "(FFFE,E0DD) not found")
            yield (group, elem), _Encapsulated(bot or b"", frames)
            return
        value = buf[pos:pos + length]
        pos += length
        yield (group, elem), value
        if (group, elem) == stop_tag:
            return


# ---------------------------------------------------------------------------
# RLE Lossless (PS3.5 Annex G): each frame is a 64-byte header (uint32
# segment count + 15 uint32 segment offsets) followed by PackBits-coded
# byte-plane segments, MSB plane first ("composite pixel code MSB first").
# PackBits is decoded by a Python byte loop.
# ---------------------------------------------------------------------------


def _packbits_decode(b: bytes, out_len: int) -> bytes:
    out = bytearray()
    i, n = 0, len(b)
    while i < n and len(out) < out_len:
        h = b[i]
        i += 1
        if h < 128:                      # literal run of h+1 bytes
            out += b[i:i + h + 1]
            i += h + 1
        elif h > 128:                    # replicate next byte 257-h times
            out += b[i:i + 1] * (257 - h)
            i += 1
        # h == 128: no-op
    if len(out) < out_len:
        raise ValueError("truncated RLE segment")
    return bytes(out[:out_len])


def _packbits_encode(b: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(b)
    while i < n:
        # find run length of identical bytes at i
        run = 1
        while i + run < n and run < 128 and b[i + run] == b[i]:
            run += 1
        if run >= 2:
            out.append(257 - run)
            out.append(b[i])
            i += run
            continue
        # literal stretch: until the next >=3-run (2-runs inside literals
        # cost the same either way) or 128 bytes
        j = i + 1
        while j < n and j - i < 128:
            if j + 2 < n and b[j] == b[j + 1] == b[j + 2]:
                break
            j += 1
        out.append(j - i - 1)
        out += b[i:j]
        i = j
    return bytes(out)


def _rle_decode_frame(blob: bytes, npix: int, bytes_per_sample: int) -> bytes:
    """One RLE frame -> raw little-endian sample bytes (length
    npix * bytes_per_sample)."""
    if len(blob) < 64:
        raise ValueError("truncated RLE frame header")
    header = struct.unpack_from("<16I", blob, 0)
    nseg = header[0]
    if nseg != bytes_per_sample:
        raise ValueError(f"RLE frame has {nseg} segments for "
                         f"{bytes_per_sample}-byte samples")
    offsets = list(header[1:1 + nseg]) + [len(blob)]
    planes = []
    for s in range(nseg):
        planes.append(np.frombuffer(
            _packbits_decode(blob[offsets[s]:offsets[s + 1]], npix),
            np.uint8))
    # planes are MSB-first; recombine to little-endian sample bytes
    out = np.empty((npix, bytes_per_sample), np.uint8)
    for s, plane in enumerate(planes):
        out[:, bytes_per_sample - 1 - s] = plane
    return out.tobytes()


def _rle_encode_frame(img: np.ndarray) -> bytes:
    """Inverse of :func:`_rle_decode_frame` for one [rows, cols] slice of a
    1- or 2-byte dtype (each byte plane PackBits-coded, MSB plane first,
    segments padded to even length per PS3.5 G.3.1)."""
    flat = np.ascontiguousarray(img).reshape(-1)
    bps = flat.dtype.itemsize
    if bps not in (1, 2):
        raise ValueError(f"RLE supports 1/2-byte samples, got {flat.dtype}")
    le = flat.view(np.uint8).reshape(-1, bps)  # little-endian byte planes
    segs = []
    for s in range(bps):                        # MSB plane first
        seg = _packbits_encode(le[:, bps - 1 - s].tobytes())
        if len(seg) % 2:
            seg += b"\x00"
        segs.append(seg)
    header = [len(segs)] + [0] * 15
    off = 64
    for s, seg in enumerate(segs):
        header[1 + s] = off
        off += len(seg)
    return struct.pack("<16I", *header) + b"".join(segs)


def _read_file(path: str) -> dict:
    with open(path, "rb") as f:
        buf = f.read()
    elems = {}
    if buf[128:132] == b"DICM":
        # file meta group is always explicit VR LE
        pos = 132
        transfer = "1.2.840.10008.1.2.1"
        for tag, val in _parse_elements(buf, pos, explicit=True, stop_tag=(0xFFFF, 0xFFFF)):
            if tag[0] == 0x0002:
                elems[tag] = val
                if tag == TAG_TRANSFER_SYNTAX:
                    transfer = val.decode("ascii", "ignore").strip("\x00 ").strip()
            else:
                break
        if transfer not in _SUPPORTED:
            raise ValueError(
                f"{path}: compressed transfer syntax {transfer} unsupported "
                f"(native LE, RLE Lossless {_RLE_LOSSLESS} and JPEG "
                f"Lossless {sorted(_JPEG_LOSSLESS)} are supported; lossy "
                "JPEG families are not — transcode with e.g. gdcmconv)")
        # find where group 0002 ends: re-scan body from after the meta group
        meta_len = None
        for tag, val in _parse_elements(buf, 132, explicit=True, stop_tag=(0xFFFF, 0xFFFF)):
            if tag == (0x0002, 0x0000):
                meta_len = struct.unpack("<I", val)[0]
                break
        if meta_len is not None:
            body_start = 132
            # skip the (0002,0000) element itself: tag(4)+VR(2)+len(2)+4
            body_start = 132 + 12 + meta_len
        else:
            raise ValueError(f"{path}: missing file meta group length")
        explicit = transfer != "1.2.840.10008.1.2"
    else:
        body_start = 0
        explicit = False
    for tag, val in _parse_elements(buf, body_start, explicit=explicit):
        elems[tag] = val
    return elems


def _decode(elems: dict, tag, kind, default=None):
    if tag not in elems:
        return default
    raw = elems[tag]
    if kind == "str":
        return raw.decode("ascii", "ignore").strip("\x00 ").strip()
    if kind == "floats":
        s = raw.decode("ascii", "ignore").strip("\x00 ")
        return [float(v) for v in s.split("\\") if v.strip()]
    if kind == "is":  # an integer string (VR IS)
        return int(raw.decode("ascii", "ignore").strip("\x00 ") or 0)
    if kind == "int":
        if len(raw) == 2:
            return struct.unpack("<H", raw)[0]
        if len(raw) == 4:
            return struct.unpack("<I", raw)[0]
        return int(raw.decode("ascii", "ignore").strip("\x00 ") or 0)
    raise ValueError(kind)


def _jpeg_frame(blob: bytes, rows: int, cols: int, bits: int, path) -> bytes:
    """One JPEG Lossless frame -> the stored (unsigned) sample bytes of
    ``bits`` each; PixelRepresentation reinterprets them as for native
    pixels. A sample that does not fit ``bits`` raises."""
    arr = decode_jpeg_lossless(blob)
    if arr.shape != (rows, cols):
        raise ValueError(
            f"{path}: JPEG frame is {arr.shape}, header says ({rows}, {cols})")
    if bits not in (8, 16):
        raise ValueError(f"{path}: JPEG Lossless with BitsAllocated {bits}")
    top = int(arr.max(initial=0))
    if top >> bits:
        raise ValueError(f"{path}: JPEG Lossless sample {top} does not fit "
                         f"{bits} allocated bits")
    return arr.astype(np.uint16 if bits == 16 else np.uint8).tobytes()


def _file_slices(e: dict, p: str) -> list[dict]:
    """Decode the frames of one parsed file (:func:`_read_file`) into
    slices: ``img`` (float32, rescaled), ``pos``, ``orient``,
    ``spacing_rc``."""
    rows = _decode(e, TAG_ROWS, "int")
    cols = _decode(e, TAG_COLS, "int")
    bits = _decode(e, TAG_BITS_ALLOC, "int", 16)
    signed = _decode(e, TAG_PIXEL_REPR, "int", 0) == 1
    nframes = max(1, _decode(e, TAG_NUM_FRAMES, "is", 1))
    spacing_rc = _decode(e, TAG_SPACING, "floats", [1.0, 1.0])  # row, col
    pos = _decode(e, TAG_POSITION, "floats", [0.0, 0.0, 0.0])
    orient = _decode(e, TAG_ORIENTATION, "floats",
                     [1.0, 0.0, 0.0, 0.0, 1.0, 0.0])
    slope = _decode(e, TAG_SLOPE, "floats", [1.0])[0]
    intercept = _decode(e, TAG_INTERCEPT, "floats", [0.0])[0]
    raw = e.get(TAG_PIXEL_DATA)
    if raw is None:
        return []
    if isinstance(raw, _Encapsulated):  # compressed frames
        transfer = _decode(e, TAG_TRANSFER_SYNTAX, "str", "")
        blobs = raw.frames(nframes)
        if transfer == _RLE_LOSSLESS:
            raw = b"".join(_rle_decode_frame(b, rows * cols, bits // 8)
                           for b in blobs)
        elif transfer in _JPEG_LOSSLESS:
            raw = b"".join(_jpeg_frame(b, rows, cols, bits, p)
                           for b in blobs)
        else:
            raise ValueError(
                f"{p}: encapsulated transfer syntax {transfer} unsupported")
    dtype = {8: np.int8 if signed else np.uint8,
             16: np.int16 if signed else np.uint16,
             32: np.int32 if signed else np.uint32}[bits]
    imgs = np.frombuffer(raw, dtype=dtype, count=nframes * rows * cols
                         ).reshape(nframes, rows, cols)
    positions = [np.asarray(pos)]
    if nframes > 1:
        # a multi-frame file: its frames step along the slice normal
        step = _decode(e, TAG_SLICE_SPACING, "floats", [])
        if not step:
            raise ValueError(
                f"{p}: {nframes} frames but no SpacingBetweenSlices "
                "(0018,0088) to place them")
        normal = np.cross(orient[:3], orient[3:])
        positions += [np.asarray(pos) + k * step[0] * normal
                      for k in range(1, nframes)]
    return [{"img": img.astype(np.float32) * slope + intercept, "pos": at,
             "orient": orient, "spacing_rc": spacing_rc}
            for img, at in zip(imgs, positions)]


def read_dicom_series(folder: str):
    """Read all DICOM slices in ``folder`` -> (data [z,y,x], Frame)."""
    files = []
    for fn in sorted(os.listdir(folder)):
        p = os.path.join(folder, fn)
        if not os.path.isfile(p):
            continue
        try:
            with open(p, "rb") as f:
                head = f.read(132)
            if head[128:132] == b"DICM":
                files.append(p)
        except OSError:
            continue
    if not files:
        raise ValueError(f"{folder}: no DICOM files found")

    slices = [sl for p in files for sl in _file_slices(_read_file(p), p)]
    if not slices:
        raise ValueError(f"{folder}: no readable DICOM slices")
    o = slices[0]["orient"]
    row_dir = np.asarray(o[:3])   # direction of increasing column index (x)
    col_dir = np.asarray(o[3:])   # direction of increasing row index (y)
    normal = np.cross(row_dir, col_dir)
    slices.sort(key=lambda s: float(np.dot(s["pos"], normal)))

    data = np.stack([s["img"] for s in slices], axis=0)  # [z, rows, cols]
    sp_rc = slices[0]["spacing_rc"]
    if len(slices) > 1:
        zs = [float(np.dot(s["pos"], normal)) for s in slices]
        dz = float(np.median(np.diff(zs)))
        if not np.isfinite(dz) or abs(dz) < 1e-6:
            # all-equal positions (missing ImagePositionPatient, or two
            # series mixed in one folder) would make spacing[2] = 0 and NaN
            # every downstream resample — fail loudly instead
            raise ValueError(
                f"{folder}: slice positions do not advance along the "
                "series normal (missing ImagePositionPatient, or multiple "
                "series mixed in one folder) — cannot derive z spacing")
    else:
        dz = 1.0
    origin = slices[0]["pos"]
    # Frame direction columns = x (col index), y (row index), z (slice) axes
    direction = np.stack([row_dir, col_dir, normal], axis=1)
    spacing = np.asarray([sp_rc[1], sp_rc[0], abs(dz)])
    return data, Frame(origin, spacing, direction)


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

_SC_SOP_CLASS = "1.2.840.10008.5.1.4.1.1.7"  # secondary capture
_EXPLICIT_LE = "1.2.840.10008.1.2.1"


def _new_uid() -> str:
    """UUID-derived UID under the standard 2.25 OID arc."""
    import uuid
    return f"2.25.{uuid.uuid4().int}"


def _pad(value: bytes, vr: bytes) -> bytes:
    if len(value) % 2:
        value += b"\x00" if vr in (b"UI", b"OB") else b" "
    return value


def _elem(group: int, elem: int, vr: bytes, value: bytes) -> bytes:
    """One explicit-VR-LE data element."""
    value = _pad(value, vr)
    if vr in _EXPLICIT_LONG_VRS:
        return struct.pack("<HH2sHI", group, elem, vr, 0, len(value)) + value
    return struct.pack("<HH2sH", group, elem, vr, len(value)) + value


def _ds(*vals) -> bytes:
    return "\\".join(f"{v:.10g}" for v in vals).encode("ascii")


def write_dicom_series(folder: str, data: np.ndarray, frame: Frame,
                       series_uid: str | None = None,
                       compress: str | None = None) -> list[str]:
    """Write ``data [z,y,x]`` as one DICOM file per slice — explicit-VR-LE
    native pixels by default, ``compress="rle"`` for RLE Lossless
    (``1.2.840.10008.1.2.5``, encapsulated PackBits byte planes), or
    ``compress="jpeg_lossless"`` for JPEG Lossless SV1
    (``1.2.840.10008.1.2.4.70``, first-party T.81 process-14 codec).

    Float data is linearly quantized to int16 and the inverse map recorded
    as RescaleSlope/RescaleIntercept, so ``read_dicom_series`` (or any DICOM
    viewer) reconstructs the original values to ~1/65000 of the range.
    Returns the written file paths in slice order.
    """
    data = np.asarray(data)
    if data.ndim != 3:
        raise ValueError(f"expected [z,y,x] volume, got shape {data.shape}")
    if compress not in (None, "rle", "jpeg_lossless"):
        raise ValueError("compress must be None, 'rle' or 'jpeg_lossless', "
                         f"got {compress!r}")
    os.makedirs(folder, exist_ok=True)
    series_uid = series_uid or _new_uid()

    dmin, dmax = float(data.min()), float(data.max())
    integral = np.issubdtype(data.dtype, np.integer)
    if integral and dmin >= -32768 and dmax <= 32767:
        slope, intercept = 1.0, 0.0
        stored = data.astype(np.int16)
    else:
        rng = max(dmax - dmin, 1e-12)
        slope = rng / 65000.0
        intercept = (dmin + dmax) / 2.0
        stored = np.clip(np.rint((data - intercept) / slope),
                         -32500, 32500).astype(np.int16)

    d = frame.direction
    sx, sy, sz = (float(s) for s in frame.spacing)
    orient = _ds(*d[:, 0], *d[:, 1])             # row dir (x), col dir (y)
    nz, rows, cols = data.shape
    paths = []
    for k in range(nz):
        pos = np.asarray(frame.origin) + k * sz * d[:, 2]
        sop_uid = f"{series_uid}.{k + 1}"
        body = b"".join([
            _elem(0x0008, 0x0016, b"UI", _SC_SOP_CLASS.encode()),
            _elem(0x0008, 0x0018, b"UI", sop_uid.encode()),
            _elem(0x0020, 0x000E, b"UI", series_uid.encode()),
            _elem(0x0020, 0x0013, b"IS", str(k + 1).encode()),
            _elem(0x0020, 0x0032, b"DS", _ds(*pos)),
            _elem(0x0020, 0x0037, b"DS", orient),
            _elem(0x0028, 0x0002, b"US", struct.pack("<H", 1)),
            _elem(0x0028, 0x0004, b"CS", b"MONOCHROME2"),
            _elem(0x0028, 0x0010, b"US", struct.pack("<H", rows)),
            _elem(0x0028, 0x0011, b"US", struct.pack("<H", cols)),
            _elem(0x0028, 0x0030, b"DS", _ds(sy, sx)),   # row\col spacing
            _elem(0x0028, 0x0100, b"US", struct.pack("<H", 16)),
            _elem(0x0028, 0x0101, b"US", struct.pack("<H", 16)),
            _elem(0x0028, 0x0102, b"US", struct.pack("<H", 15)),
            _elem(0x0028, 0x0103, b"US", struct.pack("<H", 1)),
            _elem(0x0028, 0x1052, b"DS", _ds(intercept)),
            _elem(0x0028, 0x1053, b"DS", _ds(slope)),
        ])
        if compress in ("rle", "jpeg_lossless"):
            if compress == "rle":
                blob = _rle_encode_frame(stored[k])
            else:
                blob = encode_jpeg_lossless(
                    stored[k].view(np.uint16), precision=16, predictor=1)
            if len(blob) % 2:
                blob += b"\x00"  # fragments must be even-length
            body += struct.pack("<HH2sHI", 0x7FE0, 0x0010, b"OB", 0,
                                0xFFFFFFFF)
            body += struct.pack("<HHI", 0xFFFE, 0xE000, 0)  # empty BOT item
            body += struct.pack("<HHI", 0xFFFE, 0xE000, len(blob)) + blob
            body += struct.pack("<HHI", 0xFFFE, 0xE0DD, 0)  # seq delimiter
        else:
            body += _elem(0x7FE0, 0x0010, b"OW", stored[k].tobytes())
        transfer = {None: _EXPLICIT_LE, "rle": _RLE_LOSSLESS,
                    "jpeg_lossless": _JPEG_LOSSLESS_SV1}[compress]
        meta_tail = b"".join([
            _elem(0x0002, 0x0002, b"UI", _SC_SOP_CLASS.encode()),
            _elem(0x0002, 0x0003, b"UI", sop_uid.encode()),
            _elem(0x0002, 0x0010, b"UI", transfer.encode()),
        ])
        meta = _elem(0x0002, 0x0000, b"UL", struct.pack("<I", len(meta_tail))) \
            + meta_tail
        path = os.path.join(folder, f"slice_{k + 1:04d}.dcm")
        with open(path, "wb") as f:
            f.write(b"\x00" * 128 + b"DICM" + meta + body)
        paths.append(path)
    return paths
