"""First-party JPEG Lossless (ITU-T T.81 process 14) codec for DICOM.

JPEG Lossless, Non-Hierarchical (transfer syntaxes 1.2.840.10008.1.2.4.57
and .70, the latter restricted to first-order prediction / SV1) still
appears in real CT/MR archives. This module decodes AND encodes it:

- marker/stream parsing (SOI, SOF3, DHT, DRI, SOS, RSTn, EOI) and the
  canonical Huffman tables of Annex C;
- the lossless predictor algebra of Annex H (selection values 1-7, point
  transform, modulo-2^16 reconstruction, restart-interval resets);
- the Huffman-coded DC-style difference categories (SSSS 0-16, category 16
  = +32768 with no extra bits).

The per-sample loop decodes through a 16-bit peek LUT in C++
(``native/codec.cpp:seg3d_jpegll_decode``, one call per frame, GIL
released). Where the codec did not build, a decode raises with the
compiler's message; the pure-Python loop :func:`_decode_scan_py` is the
plain version the tests hold the C++ loop against. Lossy JPEG families stay
a clear transcode-hint error in ``io/dicom.py``: bit-exactness is a
correctness contract here.

The port's own copy of ``segmentation3d_tpu/io/jpeg_lossless.py``; unlike
it, a point transform that is not below the precision raises.
"""
from __future__ import annotations

import struct

import numpy as np

from segmentation3d_tpu_torch import native

# marker bytes (second byte; first is always 0xFF)
_SOI, _EOI = 0xD8, 0xD9
_SOF3 = 0xC3
_DHT, _DRI, _SOS = 0xC4, 0xDD, 0xDA
_RST0, _RST7 = 0xD0, 0xD7
_SOF_OTHER = {0xC0, 0xC1, 0xC2, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
              0xCD, 0xCE, 0xCF}


class JpegError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Huffman tables (T.81 Annex C): canonical codes from (BITS, HUFFVAL)
# ---------------------------------------------------------------------------


def _canonical_codes(bits, huffval):
    """(code, length) per symbol in HUFFVAL order, per Annex C."""
    sizes = []
    for l, count in enumerate(bits, start=1):
        sizes.extend([l] * count)
    if len(sizes) != len(huffval):
        raise JpegError("DHT: BITS counts do not match symbol count")
    codes = []
    code = 0
    prev = 0
    for s in sizes:
        code <<= (s - prev)
        codes.append((code, s))
        code += 1
        prev = s
    return codes


def _build_lut(bits, huffval):
    """16-bit peek LUT: lut_sym[peek], lut_len[peek] (len 0 = invalid)."""
    lut_sym = np.zeros(1 << 16, np.uint8)
    lut_len = np.zeros(1 << 16, np.uint8)
    for (code, length), sym in zip(_canonical_codes(bits, huffval), huffval):
        if length > 16:
            raise JpegError("Huffman code longer than 16 bits")
        base = code << (16 - length)
        span = 1 << (16 - length)
        lut_sym[base:base + span] = sym
        lut_len[base:base + span] = length
    return lut_sym, lut_len


# fixed encoder table: categories 0..16 with Kraft sum 1 - 2^-16 (the
# all-ones max-length code stays reserved, as T.81 requires)
_ENC_LENGTHS = [2, 2, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]


def _enc_table():
    bits = [0] * 16
    for l in _ENC_LENGTHS:
        bits[l - 1] += 1
    huffval = list(range(17))  # category i gets the i-th canonical code
    codes = _canonical_codes(bits, huffval)
    return bits, huffval, codes


# ---------------------------------------------------------------------------
# stream parsing
# ---------------------------------------------------------------------------


def _parse(data: bytes) -> dict:
    """Parse markers up to (and including) SOS; return header info + the
    scan's byte offset."""
    if len(data) < 4 or data[0] != 0xFF or data[1] != _SOI:
        raise JpegError("not a JPEG stream (missing SOI)")
    pos = 2
    huff = {}
    frame = None
    ri = 0
    n = len(data)
    while pos + 4 <= n:
        if data[pos] != 0xFF:
            raise JpegError(f"expected marker at byte {pos}")
        m = data[pos + 1]
        pos += 2
        if m == 0x01 or _RST0 <= m <= _RST7:  # parameterless
            continue
        if pos + 2 > n:
            raise JpegError("truncated marker segment")
        seglen = struct.unpack_from(">H", data, pos)[0]
        seg = data[pos + 2:pos + seglen]
        if len(seg) != seglen - 2:
            raise JpegError("truncated marker segment")
        if m == _SOF3:
            p, y, x, nf = struct.unpack_from(">BHHB", seg, 0)
            comps = []
            for ci in range(nf):
                c, hv, tq = struct.unpack_from(">BBB", seg, 5 + 3 * ci)
                comps.append({"id": c, "h": hv >> 4, "v": hv & 0xF})
            frame = {"precision": p, "height": y, "width": x, "comps": comps}
        elif m in _SOF_OTHER:
            raise JpegError(
                f"SOF{m - 0xC0} is not lossless process 14 (only SOF3 "
                "streams are JPEG Lossless)")
        elif m == _DHT:
            off = 0
            while off < len(seg):
                tcth = seg[off]
                bits = list(seg[off + 1:off + 17])
                nsym = sum(bits)
                huffval = list(seg[off + 17:off + 17 + nsym])
                if len(huffval) != nsym:
                    raise JpegError("truncated DHT")
                huff[(tcth >> 4, tcth & 0xF)] = (bits, huffval)
                off += 17 + nsym
        elif m == _DRI:
            ri = struct.unpack_from(">H", seg, 0)[0]
        elif m == _SOS:
            ns = seg[0]
            scomps = []
            for ci in range(ns):
                cs, tdta = struct.unpack_from(">BB", seg, 1 + 2 * ci)
                scomps.append({"id": cs, "td": tdta >> 4})
            ss, se, ahal = struct.unpack_from(">BBB", seg, 1 + 2 * ns)
            if frame is None:
                raise JpegError("SOS before SOF3")
            return {"frame": frame, "huff": huff, "ri": ri,
                    "scomps": scomps, "predictor": ss, "pt": ahal & 0xF,
                    "scan_at": pos + seglen}
        pos += seglen
    raise JpegError("no SOS marker found")


# ---------------------------------------------------------------------------
# scan decoding: the pure-Python plain version of the C++ loop in
# native/codec.cpp:seg3d_jpegll_decode (keep the two in exact agreement)
# ---------------------------------------------------------------------------


def _decode_scan_py(scan, lut_sym, lut_len, width, height, precision,
                    predictor, pt, ri):
    out = np.zeros(height * width, np.uint16)
    default = 1 << (precision - pt - 1)
    bitbuf = 0
    nbits = 0
    pos = 0
    n = len(scan)
    reset = True  # next sample predicts the default (scan start / restart)
    until_rst = ri if ri else -1

    def fill():
        nonlocal bitbuf, nbits, pos
        while nbits <= 24:
            if pos >= n:
                bitbuf = (bitbuf << 8) & 0xFFFFFFFF
                nbits += 8
                continue
            b = scan[pos]
            if b == 0xFF:
                nxt = scan[pos + 1] if pos + 1 < n else _EOI
                if nxt == 0x00:
                    pos += 2
                elif _RST0 <= nxt <= _RST7:
                    # restart marker: consumed by the restart handler below
                    bitbuf = (bitbuf << 8) & 0xFFFFFFFF
                    nbits += 8
                    continue
                else:  # EOI / next marker: pad with zero bits
                    bitbuf = (bitbuf << 8) & 0xFFFFFFFF
                    nbits += 8
                    continue
            else:
                pos += 1
            bitbuf = ((bitbuf << 8) | b) & 0xFFFFFFFF
            nbits += 8

    def take(k):
        nonlocal bitbuf, nbits
        if k == 0:
            return 0
        fill()
        v = (bitbuf >> (nbits - k)) & ((1 << k) - 1)
        nbits -= k
        return v

    for row in range(height):
        base = row * width
        for col in range(width):
            if until_rst == 0:
                # consume the RSTn marker and restart the entropy decoder:
                # fill() never advances past a restart marker, so ``pos``
                # still points at (or just before) it — scan forward,
                # skip it, and drop all buffered bits (they are the
                # previous interval's 1-padding)
                while pos + 1 < n and not (scan[pos] == 0xFF and
                                           _RST0 <= scan[pos + 1] <= _RST7):
                    pos += 1
                if pos + 1 < n:
                    pos += 2  # skip the marker
                bitbuf = 0
                nbits = 0
                reset = True
                until_rst = ri
            fill()
            peek = (bitbuf >> (nbits - 16)) & 0xFFFF
            ssss = int(lut_sym[peek])
            length = int(lut_len[peek])
            if length == 0:
                raise JpegError("invalid Huffman code in scan")
            nbits -= length
            if ssss == 16:
                diff = 32768
            elif ssss == 0:
                diff = 0
            else:
                v = take(ssss)
                diff = v if v >= (1 << (ssss - 1)) else v - (1 << ssss) + 1
            if reset:
                px = default
                reset = False
            elif row == 0:
                px = int(out[base + col - 1])                    # Ra
            elif col == 0:
                px = int(out[base - width])                      # Rb
            else:
                ra = int(out[base + col - 1])
                rb = int(out[base - width + col])
                rc = int(out[base - width + col - 1])
                if predictor == 1:
                    px = ra
                elif predictor == 2:
                    px = rb
                elif predictor == 3:
                    px = rc
                elif predictor == 4:
                    px = ra + rb - rc
                elif predictor == 5:
                    px = ra + ((rb - rc) >> 1)
                elif predictor == 6:
                    px = rb + ((ra - rc) >> 1)
                elif predictor == 7:
                    px = (ra + rb) >> 1
                else:
                    raise JpegError(f"predictor {predictor} invalid")
            out[base + col] = (px + diff) & 0xFFFF
            if until_rst > 0:
                until_rst -= 1
    if pt:
        out <<= pt
    return out.reshape(height, width)


def _decode_scan_native(scan, lut_sym, lut_len, width, height, precision,
                        predictor, pt, ri):
    """The C++ scan loop (raises when the native codec did not build)."""
    try:
        out = native.jpegll_decode(scan, lut_sym, lut_len, width, height,
                                   precision, predictor, pt, ri)
    except ValueError as e:  # an invalid Huffman code in the scan
        raise JpegError(str(e)) from e
    if pt:
        out <<= pt
    return out


def decode_jpeg_lossless(data: bytes) -> np.ndarray:
    """Decode one single-component JPEG Lossless (SOF3) frame -> uint16
    [rows, cols]. Raises :class:`JpegError` on anything that is not a
    well-formed process-14 stream."""
    info = _parse(bytes(data))
    frame = info["frame"]
    if len(frame["comps"]) != 1 or len(info["scomps"]) != 1:
        raise JpegError(
            f"{len(frame['comps'])}-component JPEG Lossless not supported "
            "(DICOM CT/MR archives are monochrome)")
    if not (2 <= frame["precision"] <= 16):
        raise JpegError(f"precision {frame['precision']} out of range")
    if not (1 <= info["predictor"] <= 7):
        raise JpegError(f"predictor selection {info['predictor']} invalid "
                        "for a lossless scan")
    if info["pt"] >= frame["precision"]:
        raise JpegError(f"point transform {info['pt']} is not below the "
                        f"precision {frame['precision']}")
    td = info["scomps"][0]["td"]
    key = (0, td)
    if key not in info["huff"]:
        raise JpegError(f"missing Huffman table {td}")
    lut_sym, lut_len = _build_lut(*info["huff"][key])
    scan = data[info["scan_at"]:]
    # loud-failure policy (matches io/dicom.py): a scan cut off before EOI
    # would otherwise decode its tail from the bit reader's zero padding
    # and return silently wrong voxels
    if not bytes(scan).rstrip(b"\x00").endswith(bytes([0xFF, _EOI])):
        raise JpegError("truncated scan: EOI (FFD9) not found")
    return _decode_scan_native(
        scan, lut_sym, lut_len, frame["width"], frame["height"],
        frame["precision"], info["predictor"], info["pt"], info["ri"])


# ---------------------------------------------------------------------------
# encoder (SV1 by default) — powers write_dicom_series(compress=
# "jpeg_lossless") and the decoder's round-trip tests
# ---------------------------------------------------------------------------


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nacc = 0

    def put(self, code, length):
        self.acc = (self.acc << length) | code
        self.nacc += length
        while self.nacc >= 8:
            b = (self.acc >> (self.nacc - 8)) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0x00)  # byte stuffing
            self.nacc -= 8
        self.acc &= (1 << self.nacc) - 1

    def flush(self):
        if self.nacc:
            pad = 8 - self.nacc
            self.put((1 << pad) - 1, pad)  # 1-bit padding per T.81


def encode_jpeg_lossless(img: np.ndarray, precision: int = 16,
                         predictor: int = 1, pt: int = 0,
                         restart_interval: int = 0) -> bytes:
    """Encode a [rows, cols] unsigned array as JPEG Lossless (SOF3, one
    component). ``predictor`` 1 (= Ra, "selection value 1") is what transfer
    syntax 1.2.840.10008.1.2.4.70 mandates."""
    img = np.ascontiguousarray(img)
    if img.ndim != 2:
        raise JpegError("expected a single [rows, cols] frame")
    if img.dtype != np.uint16:
        if np.issubdtype(img.dtype, np.signedinteger):
            raise JpegError("encode operates on the stored (unsigned) view")
        img = img.astype(np.uint16)
    h, w = img.shape
    if int(img.max(initial=0)) >= (1 << precision):
        raise JpegError(f"sample exceeds precision {precision}")
    if not (1 <= predictor <= 7):
        raise JpegError(f"predictor {predictor} invalid")
    if not (0 <= pt < precision):
        raise JpegError(f"point transform {pt} is not below the precision "
                        f"{precision}")

    # differences, row-major, per Annex H prediction
    a = img.astype(np.int32) >> pt
    px = np.empty_like(a)
    px[0, 0] = 1 << (precision - pt - 1)
    px[0, 1:] = a[0, :-1]                       # first line: Ra
    px[1:, 0] = a[:-1, 0]                       # first column: Rb
    ra, rb, rc = a[1:, :-1], a[:-1, 1:], a[:-1, :-1]
    if predictor == 1:
        px[1:, 1:] = ra
    elif predictor == 2:
        px[1:, 1:] = rb
    elif predictor == 3:
        px[1:, 1:] = rc
    elif predictor == 4:
        px[1:, 1:] = ra + rb - rc
    elif predictor == 5:
        px[1:, 1:] = ra + ((rb - rc) >> 1)
    elif predictor == 6:
        px[1:, 1:] = rb + ((ra - rc) >> 1)
    else:
        px[1:, 1:] = (ra + rb) >> 1
    diffs = (a - px).reshape(-1)
    if restart_interval:
        # samples at restart boundaries predict the default again
        for s in range(restart_interval, h * w, restart_interval):
            r, c = divmod(s, w)
            diffs[s] = a[r, c] - (1 << (precision - pt - 1))
    # mod-2^16 arithmetic: map into [-32768, 32767] (32768 encodes as
    # category 16); the decoder's & 0xFFFF undoes the wrap exactly
    diffs = ((diffs + 32768) & 0xFFFF) - 32768

    bits, huffval, codes = _enc_table()
    wtr = _BitWriter()
    next_rst = 0
    for i, d in enumerate(diffs):
        if restart_interval and i and i % restart_interval == 0:
            wtr.flush()
            wtr.out += bytes([0xFF, _RST0 + (next_rst & 7)])
            next_rst += 1
        d = int(d)
        if d == 0:
            ssss = 0
        elif d == 32768 or d == -32768:
            ssss = 16
        else:
            ssss = int(abs(d)).bit_length()
        code, length = codes[ssss]
        wtr.put(code, length)
        if 0 < ssss < 16:
            v = d if d >= 0 else d + (1 << ssss) - 1
            wtr.put(v & ((1 << ssss) - 1), ssss)
    wtr.flush()

    def seg(marker, payload):
        return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) \
            + payload

    dht = seg(_DHT, bytes([0x00]) + bytes(bits) + bytes(huffval))
    sof = seg(_SOF3, struct.pack(">BHHB", precision, h, w, 1)
              + bytes([1, 0x11, 0]))
    sos = seg(_SOS, bytes([1, 1, 0x00, predictor, 0, pt]))
    head = bytes([0xFF, _SOI])
    dri = seg(_DRI, struct.pack(">H", restart_interval)) \
        if restart_interval else b""
    return head + dht + dri + sof + sos + bytes(wtr.out) \
        + bytes([0xFF, _EOI])
