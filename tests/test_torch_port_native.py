"""The port's native host codec (``segmentation3d_tpu_torch/native``): its
build, libdeflate's gzip against zlib's, and the C++ JPEG Lossless scan loop
against the port's Python loop and the JAX package's decoder."""
import gzip
import threading
import zlib

import numpy as np
import pytest

from segmentation3d_tpu.io.jpeg_lossless import (
    decode_jpeg_lossless as jax_decode, encode_jpeg_lossless as jax_encode)
from segmentation3d_tpu_torch import native
from segmentation3d_tpu_torch.io import Volume, jpeg_lossless as jl, nifti, read_image
from segmentation3d_tpu_torch.io import write_image
from segmentation3d_tpu_torch.ops.geometry import Frame

PAYLOAD = np.random.default_rng(0).integers(-900, 1500, 60_000, dtype=np.int16).tobytes()

#: .gz blobs and what they hold
GZ = {
    "single": (gzip.compress(PAYLOAD, 1), PAYLOAD),
    "level9": (gzip.compress(PAYLOAD, 9), PAYLOAD),
    "multi_member": (gzip.compress(PAYLOAD[:999]) + gzip.compress(PAYLOAD[999:50_000])
                     + gzip.compress(PAYLOAD[50_000:]), PAYLOAD),
    "zero_padded": (gzip.compress(PAYLOAD) + b"\x00" * 512, PAYLOAD),
    "empty_payload": (gzip.compress(b""), b""),
}


@pytest.fixture
def zlib_only(monkeypatch):
    """The process's codec replaced by a build without libdeflate."""
    codec = native.Codec.load(builds=native.BUILDS[1:])
    monkeypatch.setattr(native, "_codec", codec)
    return codec


def test_codec_builds_with_libdeflate():
    assert native.status() == "libdeflate"
    path = native.library_path(native.BUILDS[0][1])
    assert path.startswith(native.BUILD_DIR) and path.endswith(".so")
    assert native.library_path([]) != path  # the flags are hashed


@pytest.mark.parametrize("name", list(GZ))
def test_gunzip_matches_zlib(name):
    blob, payload = GZ[name]
    assert native.gunzip(blob) == payload
    assert nifti.zlib_gunzip(blob) == payload
    assert nifti.gunzip(blob) == payload


@pytest.mark.parametrize("build", ["libdeflate", "zlib-only"])
def test_corrupt_second_member_raises_as_zlib(build, zlib_only, monkeypatch):
    if build == "libdeflate":
        monkeypatch.setattr(native, "_codec", native.Codec.load())
    corrupt = gzip.compress(b"x" * 1000) + b"\x1f\x8b" + b"\xde\xad" * 20
    assert native.gunzip(corrupt) is None
    with pytest.raises(zlib.error) as ref:
        nifti.zlib_gunzip(corrupt)
    with pytest.raises(zlib.error, match=str(ref.value)):
        nifti.gunzip(corrupt)


def test_truncated_gz_reads_as_zlib_and_fails_the_volume(tmp_path):
    data = np.arange(24 * 20 * 16, dtype=np.int16).reshape(24, 20, 16)
    p = str(tmp_path / "v.nii.gz")
    write_image(Volume(data, Frame.identity()), p)
    with open(p, "rb") as f:
        blob = f.read()
    cut = blob[:len(blob) // 2]
    assert native.gunzip(cut) is None
    assert nifti.gunzip(cut) == nifti.zlib_gunzip(cut)
    with open(p, "wb") as f:
        f.write(cut)
    with pytest.raises(ValueError):
        read_image(p)


@pytest.mark.parametrize("level", [1, 6, 9])
def test_gzip_compress_inflates_with_zlib(level):
    blob = native.gzip_compress(PAYLOAD, level)
    assert blob[:2] == b"\x1f\x8b"
    assert gzip.decompress(blob) == PAYLOAD
    assert nifti.gzip_bytes(memoryview(PAYLOAD), level) == blob


def test_nifti_gz_written_by_libdeflate_reads_everywhere(tmp_path):
    from segmentation3d_tpu.io import read_image as jax_read
    data = np.random.default_rng(1).integers(-500, 1200, (24, 20, 16)).astype(np.int16)
    p = str(tmp_path / "v.nii.gz")
    write_image(Volume(data, Frame.identity()), p)
    with open(p, "rb") as f:
        raw = f.read()
    assert gzip.decompress(raw)[352:] == data.tobytes()
    np.testing.assert_array_equal(read_image(p).data, data)
    np.testing.assert_array_equal(jax_read(p).data, data)


def test_zlib_only_build_reads_the_same_bytes(zlib_only, tmp_path):
    assert zlib_only.status == "zlib-only" and native.status() == "zlib-only"
    assert not hasattr(zlib_only.lib, "seg3d_gunzip_member")
    for blob, payload in GZ.values():
        assert native.gunzip(blob) is None
        assert nifti.gunzip(blob) == payload
    assert native.gzip_compress(PAYLOAD) is None
    assert gzip.decompress(nifti.gzip_bytes(PAYLOAD)) == PAYLOAD
    img = _rand((9, 11), 1 << 12)
    np.testing.assert_array_equal(jl.decode_jpeg_lossless(
        jl.encode_jpeg_lossless(img, precision=12)), img)


def test_build_without_gzip_symbols_loads_as_zlib_only(monkeypatch):
    """A build that links ``-ldeflate`` but compiles the gzip entry points
    out (as on a host with the library and no header) loads as
    ``zlib-only`` and reads ``.gz`` through zlib."""
    codec = native.Codec.load(
        builds=[("libdeflate", ["-ldeflate", "-DSEG3D_DISABLE_LIBDEFLATE"])])
    assert codec.status == "zlib-only" and not codec.has_gzip
    monkeypatch.setattr(native, "_codec", codec)
    for blob, payload in GZ.values():
        assert native.gunzip(blob) is None
        assert nifti.gunzip(blob) == payload
    img = _rand((9, 11), 1 << 12)
    np.testing.assert_array_equal(jl.decode_jpeg_lossless(
        jl.encode_jpeg_lossless(img, precision=12)), img)


def test_failed_build_raises_on_jpeg_with_the_compiler_message(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "FLAGS", native.FLAGS + ["-fno-such-codec-flag"])
    codec = native.Codec.load()
    assert codec.lib is None and codec.status.startswith("build failed")
    assert "no-such-codec-flag" in codec.status
    monkeypatch.setattr(native, "_codec", codec)
    blob = jl.encode_jpeg_lossless(_rand((8, 8), 1 << 12), precision=12)
    with pytest.raises(RuntimeError, match="no-such-codec-flag"):
        jl.decode_jpeg_lossless(blob)
    gz, payload = GZ["single"]
    assert nifti.gunzip(gz) == payload  # gzip still reads, through zlib


def test_concurrent_builds_all_load(monkeypatch, tmp_path):
    """Builds racing on an empty build directory each load a whole
    library (temporary file + ``os.replace``)."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    out = []
    threads = [threading.Thread(target=lambda: out.append(native.Codec.load().status))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert out == ["libdeflate"] * 4
    assert [p.name for p in tmp_path.iterdir()] == \
        [native.library_path(native.BUILDS[0][1]).rsplit("/", 1)[1]]


def _rand(shape, hi, seed=0):
    return np.random.default_rng(seed).integers(0, hi, shape).astype(np.uint16)


def _scan_args(blob):
    info = jl._parse(blob)
    f = info["frame"]
    lut_sym, lut_len = jl._build_lut(*info["huff"][(0, info["scomps"][0]["td"])])
    return (blob[info["scan_at"]:], lut_sym, lut_len, f["width"], f["height"],
            f["precision"], info["predictor"], info["pt"], info["ri"])


#: (predictor, precision, point transform, restart interval, shape)
SCANS = [(p, 12, 0, 0, (13, 17)) for p in range(1, 8)] + [
    (1, 16, 0, 0, (32, 32)), (4, 10, 2, 0, (16, 12)), (7, 12, 3, 37, (16, 16)),
    (5, 16, 1, 64, (20, 24)), (6, 8, 0, 5, (9, 7)), (2, 12, 11, 0, (8, 8))]


@pytest.mark.parametrize("predictor,precision,pt,ri,shape", SCANS)
def test_native_scan_matches_python_and_jax(predictor, precision, pt, ri, shape):
    img = _rand(shape, 1 << precision, seed=predictor + pt)
    img = (img >> pt) << pt  # a point transform drops the low bits
    img[0, 0], img[-1, -1] = 0, (1 << precision) - (1 << pt)
    for encode in (jl.encode_jpeg_lossless, jax_encode):
        blob = encode(img, precision=precision, predictor=predictor, pt=pt,
                      restart_interval=ri)
        args = _scan_args(blob)
        got = jl._decode_scan_native(*args)
        np.testing.assert_array_equal(got, jl._decode_scan_py(*args))
        np.testing.assert_array_equal(got, img)
        np.testing.assert_array_equal(jl.decode_jpeg_lossless(blob), jax_decode(blob))


def test_truncated_scan_raises():
    blob = jl.encode_jpeg_lossless(_rand((16, 16), 1 << 12), precision=12)
    with pytest.raises(jl.JpegError, match="EOI"):
        jl.decode_jpeg_lossless(blob[:-10])


def test_invalid_huffman_code_raises():
    """Bits that match no code (the all-ones code is reserved) raise from
    the C++ loop as from the Python one."""
    blob = jl.encode_jpeg_lossless(_rand((8, 8), 1 << 12), precision=12)
    at = jl._parse(blob)["scan_at"]
    bad = blob[:at] + b"\xff\x00" * 4 + blob[at + 8:]
    args = _scan_args(bad)
    with pytest.raises(jl.JpegError, match="Huffman"):
        jl._decode_scan_py(*args)
    with pytest.raises(jl.JpegError, match="code 2"):
        jl.decode_jpeg_lossless(bad)


@pytest.mark.parametrize("pt", [12, 13, 15])
def test_point_transform_not_below_precision_raises(pt):
    """A fault of the JAX decoder fixed in the port: pt >= precision would
    shift by a negative count in the C++ loop; the port raises."""
    blob = bytearray(jl.encode_jpeg_lossless(_rand((8, 8), 1 << 12), precision=12))
    sos = bytes(blob).index(b"\xff\xda")
    blob[sos + 9] = pt  # Ah/Al: the point transform of the SOS segment
    with pytest.raises(jl.JpegError, match="point transform"):
        jl.decode_jpeg_lossless(bytes(blob))
    with pytest.raises(jl.JpegError, match="point transform"):
        jl.encode_jpeg_lossless(_rand((8, 8), 16), precision=12, pt=pt)
