"""ctypes loader for the port's native host codec (``codec.cpp``).

The codec is compiled with ``g++`` at first use into
``build/native/libseg3dcodec_<hash>.so`` beside the package (the hash covers
the source and the flags, so an edited source rebuilds; a temporary file and
``os.replace`` keep concurrent builds from colliding). The first build
links libdeflate; where that fails, a second build compiles the gzip entry
points out (``-DSEG3D_DISABLE_LIBDEFLATE``) and keeps the JPEG Lossless
decoder. :func:`status` says which build loaded: ``"libdeflate"``,
``"zlib-only"`` or the compiler's error.

- :func:`gunzip` / :func:`gzip_compress` return ``None`` unless the
  libdeflate build loaded; the callers (``io/nifti.py``, ``io/nrrd.py``)
  then use zlib. ``gunzip`` also returns ``None`` on data libdeflate
  rejects, so that zlib reports it.
- :func:`jpegll_decode` raises when the codec did not build at all: a JPEG
  Lossless read does not fall back to the Python scan loop, which only the
  tests run.

ctypes calls release the GIL, so several decode threads run in parallel.
The port's own copy of ``segmentation3d_tpu/native/__init__.py`` (its
decoder and gzip parts).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "native", "codec.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "native")
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
#: the builds tried in order: (status, extra flags)
BUILDS = (("libdeflate", ["-ldeflate"]),
          ("zlib-only", ["-DSEG3D_DISABLE_LIBDEFLATE"]))

_U8P = ctypes.POINTER(ctypes.c_uint8)
_U16P = ctypes.POINTER(ctypes.c_uint16)
_SZP = ctypes.POINTER(ctypes.c_size_t)


def library_path(extra) -> str:
    """Where a build with ``extra`` flags goes: named by the hash of the
    source and of every flag."""
    h = hashlib.sha256(" ".join(FLAGS + list(extra)).encode() + b"\0")
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libseg3dcodec_{h.hexdigest()[:16]}.so")


def _compile(extra) -> str:
    """Build (or find) the library for ``extra``; raises ``RuntimeError``
    with the compiler's message when ``g++`` fails."""
    path = library_path(extra)
    if os.path.isfile(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *FLAGS, SRC, "-o", tmp, *extra]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                           f"{proc.stderr.strip()}")
    os.replace(tmp, path)
    return path


class Codec:
    """One loaded build of ``codec.cpp`` from ``path`` (``lib`` and ``path``
    are ``None`` when no build succeeded; ``status`` then holds the
    compiler's error)."""

    def __init__(self, lib, status, path=None):
        self.lib, self.status, self.path = lib, status, path
        self.has_gzip = status == "libdeflate"

    @classmethod
    def load(cls, builds=BUILDS) -> "Codec":
        """Try ``builds`` in order; the first that compiles and loads wins.
        The status comes from what the library exports, not from the
        build's name: a build that links ``-ldeflate`` while the header is
        missing compiles the gzip entry points out and loads as
        ``"zlib-only"``."""
        errors = []
        for _, extra in builds:
            try:
                lib = ctypes.CDLL(path := _compile(extra))
            except (RuntimeError, OSError) as e:
                errors.append(str(e))
                continue
            has_gzip = hasattr(lib, "seg3d_gunzip_member")
            _declare(lib, has_gzip)
            return cls(lib, "libdeflate" if has_gzip else "zlib-only", path)
        return cls(None, "build failed: " + "\n".join(errors))

    def gunzip(self, raw: bytes) -> bytes | None:
        """One-shot gunzip of a complete (possibly multi-member, possibly
        zero-padded) ``.gz`` blob through libdeflate; ``None`` when the
        libdeflate build is not loaded or the data is not a well-formed
        stream, so that the caller's zlib path decodes or reports it. The
        first attempt sizes the output from the last member's ISIZE
        trailer; a short buffer grows and retries."""
        if not self.has_gzip or len(raw) < 18:  # 18: the smallest member
            return None
        lib = self.lib
        src = np.frombuffer(raw, np.uint8)
        members = []
        off, n = 0, src.size
        while off < n:
            cap = max(int.from_bytes(raw[-4:], "little"), 1, (n - off) * 2)
            for _ in range(3):
                dst = np.empty(cap, np.uint8)
                in_used, out_used = ctypes.c_size_t(), ctypes.c_size_t()
                rc = lib.seg3d_gunzip_member(
                    src[off:].ctypes.data_as(_U8P), n - off,
                    dst.ctypes.data_as(_U8P), cap,
                    ctypes.byref(in_used), ctypes.byref(out_used))
                if rc == 0:
                    members.append(dst[:out_used.value].tobytes())
                    off += in_used.value
                    break
                if rc == 1 and cap < (1 << 34):
                    cap *= 4
                    continue
                if members and not src[off:].any():
                    off = n  # zero padding after the members: done
                    break
                # bad data (a corrupt or truncated member): zlib reports it
                return None
            else:
                return None
            if off < n and in_used.value == 0:
                return None
        return members[0] if len(members) == 1 else b"".join(members)

    def gzip_compress(self, payload, level: int = 1) -> bytes | None:
        """One-shot gzip of a bytes-like payload at zlib's ``level`` (1-9;
        libdeflate's scale agrees there); ``None`` when the libdeflate
        build is not loaded."""
        if not self.has_gzip:
            return None
        src = np.frombuffer(payload, np.uint8)
        level = min(max(int(level), 1), 12)
        cap = self.lib.seg3d_gzip_bound(src.size, level)
        if cap == 0:
            return None
        dst = np.empty(cap, np.uint8)
        out = self.lib.seg3d_gzip_compress(src.ctypes.data_as(_U8P), src.size,
                                           level, dst.ctypes.data_as(_U8P), cap)
        return dst[:out].tobytes() if out else None

    def jpegll_decode(self, scan, lut_sym, lut_len, width, height, precision,
                      predictor, pt, ri) -> np.ndarray:
        """Decode one JPEG Lossless scan into a uint16 ``[height, width]``
        array of the point-transformed samples (the caller shifts by
        ``pt``). Raises ``RuntimeError`` when the codec did not build and
        ``ValueError`` on an invalid Huffman code."""
        if self.lib is None:
            raise RuntimeError(f"the native codec is not available: {self.status}")
        if not (2 <= precision <= 16 and 1 <= predictor <= 7
                and 0 <= pt < precision and width > 0 and height > 0 and ri >= 0):
            raise ValueError(
                f"invalid scan parameters: precision {precision}, predictor "
                f"{predictor}, pt {pt}, {width}x{height}, restart {ri}")
        buf = np.ascontiguousarray(np.frombuffer(scan, np.uint8))
        luts = [np.ascontiguousarray(t, np.uint8) for t in (lut_sym, lut_len)]
        if any(t.shape != (1 << 16,) for t in luts):
            raise ValueError("Huffman LUTs must hold 65536 entries")
        out = np.empty((height, width), np.uint16)
        rc = self.lib.seg3d_jpegll_decode(
            buf.ctypes.data_as(_U8P), buf.size, luts[0].ctypes.data_as(_U8P),
            luts[1].ctypes.data_as(_U8P), width, height, precision, predictor,
            pt, ri, out.ctypes.data_as(_U16P))
        if rc != 0:
            raise ValueError(f"native JPEG Lossless decode failed (code {rc})")
        return out


def _declare(lib, has_gzip) -> None:
    lib.seg3d_jpegll_decode.argtypes = [
        _U8P, ctypes.c_size_t, _U8P, _U8P, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _U16P]
    lib.seg3d_jpegll_decode.restype = ctypes.c_int
    if has_gzip:
        lib.seg3d_gzip_bound.argtypes = [ctypes.c_size_t, ctypes.c_int]
        lib.seg3d_gzip_bound.restype = ctypes.c_size_t
        lib.seg3d_gzip_compress.argtypes = [_U8P, ctypes.c_size_t, ctypes.c_int,
                                            _U8P, ctypes.c_size_t]
        lib.seg3d_gzip_compress.restype = ctypes.c_size_t
        lib.seg3d_gunzip_member.argtypes = [_U8P, ctypes.c_size_t, _U8P,
                                            ctypes.c_size_t, _SZP, _SZP]
        lib.seg3d_gunzip_member.restype = ctypes.c_int


_lock = threading.Lock()
_codec = None


def codec() -> Codec:
    """The process's codec, built and loaded at the first call."""
    global _codec
    with _lock:
        if _codec is None:
            _codec = Codec.load()
        return _codec


def status() -> str:
    """Which build loaded: ``"libdeflate"``, ``"zlib-only"`` or
    ``"build failed: <compiler error>"``."""
    return codec().status


def gunzip(raw: bytes) -> bytes | None:
    """:meth:`Codec.gunzip` of the process's codec."""
    return codec().gunzip(raw)


def gzip_compress(payload, level: int = 1) -> bytes | None:
    """:meth:`Codec.gzip_compress` of the process's codec."""
    return codec().gzip_compress(payload, level)


def jpegll_decode(*args) -> np.ndarray:
    """:meth:`Codec.jpegll_decode` of the process's codec."""
    return codec().jpegll_decode(*args)
