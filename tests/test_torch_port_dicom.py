"""DICOM series in the port (``io/dicom.py``, ``io/jpeg_lossless.py``,
``utils/dicom_helper.py``) against the JAX package: series written by either
package read in the other with equal voxels and frames, for native, RLE and
JPEG Lossless pixels; the same refusals; and the JAX reader's faults that
the port fixes (multi-frame files, 8-bit JPEG samples that do not fit)."""
import os
import re
import shutil
import struct

import numpy as np
import pytest

from segmentation3d_tpu.core.seg_infer import find_cases as jax_find_cases
from segmentation3d_tpu.io import dicom as jd
from segmentation3d_tpu.io import Volume as JaxVolume
from segmentation3d_tpu.ops.geometry import Frame as JaxFrame
from segmentation3d_tpu.utils import dicom_helper as jax_helper
from segmentation3d_tpu_torch.core.seg_infer import find_cases
from segmentation3d_tpu_torch.io import Volume, dicom, read_image
from segmentation3d_tpu_torch.io.jpeg_lossless import encode_jpeg_lossless
from segmentation3d_tpu_torch.ops.geometry import Frame
from segmentation3d_tpu_torch.utils import dicom_helper

COMPRESS = [None, "rle", "jpeg_lossless"]
KINDS = ["int16", "uint16", "float"]


def _frame(port=True, rotated=True):
    th = 0.4 if rotated else 0.0
    d = np.array([[np.cos(th), -np.sin(th), 0.0],
                  [np.sin(th), np.cos(th), 0.0], [0.0, 0.0, 1.0]])
    return (Frame if port else JaxFrame)(
        np.array([3.0, -7.0, 11.0]), np.array([0.7, 0.8, 2.5]), d)


def _data(kind, seed, shape=(3, 16, 20)):
    rng = np.random.default_rng(seed)
    if kind == "int16":
        return rng.integers(-1000, 2000, shape).astype(np.int16)
    if kind == "uint16":  # beyond int16: stored through slope/intercept
        return rng.integers(0, 60000, shape).astype(np.uint16)
    return rng.uniform(-800.0, 1200.0, shape).astype(np.float32)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("compress", COMPRESS)
def test_jax_written_series_reads_in_port(tmp_path, compress, kind):
    data = _data(kind, 0)
    jd.write_dicom_series(str(tmp_path), data, _frame(False), compress=compress)
    got, frame = dicom.read_dicom_series(str(tmp_path))
    ref, ref_frame = jd.read_dicom_series(str(tmp_path))
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == ref.dtype == np.float32
    assert frame.to_dict() == ref_frame.to_dict()
    assert frame.isclose(_frame(), tol=1e-6)
    vol = read_image(str(tmp_path))  # the dispatch of a directory
    np.testing.assert_array_equal(vol.data, ref)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("compress", COMPRESS)
def test_port_written_series_reads_in_jax(tmp_path, compress, kind):
    data = _data(kind, 1)
    paths = dicom.write_dicom_series(str(tmp_path), data, _frame(), compress=compress)
    assert len(paths) == data.shape[0]
    ref, ref_frame = jd.read_dicom_series(str(tmp_path))
    got, frame = dicom.read_dicom_series(str(tmp_path))
    np.testing.assert_array_equal(ref, got)
    assert ref_frame.to_dict() == frame.to_dict()
    if kind == "int16":
        np.testing.assert_array_equal(ref, data)


def test_dicom_helper_facade(tmp_path):
    data = (np.arange(4 * 6 * 8).reshape(4, 6, 8) % 100).astype(np.int16)
    dicom_helper.write_dicom_series(Volume(data, _frame()), str(tmp_path / "s"))
    back = dicom_helper.read_dicom_series(str(tmp_path / "s"))
    ref = jax_helper.read_dicom_series(str(tmp_path / "s"))
    np.testing.assert_array_equal(back.data, data)
    np.testing.assert_array_equal(back.data, ref.data)
    assert back.frame.to_dict() == ref.frame.to_dict()
    jax_helper.write_dicom_series(JaxVolume(data, _frame(False)), str(tmp_path / "j"))
    np.testing.assert_array_equal(
        dicom_helper.read_dicom_series(str(tmp_path / "j")).data, data)


def test_find_cases_on_series_folders(tmp_path):
    data = (np.arange(4 * 8 * 8).reshape(4, 8, 8) % 500).astype(np.int16)
    for s in ("sA", "sB"):
        dicom.write_dicom_series(str(tmp_path / "root" / s), data, _frame())
    (tmp_path / "root" / "notes").mkdir()
    for p in (tmp_path / "root", tmp_path / "root" / "sA", tmp_path / "root" / "notes"):
        assert find_cases(str(p)) == jax_find_cases(str(p))
    assert find_cases(str(tmp_path / "root")) == [
        [str(tmp_path / "root" / "sA")], [str(tmp_path / "root" / "sB")]]


@pytest.mark.parametrize("seed", [0, 1])
def test_packbits_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for case in (b"", b"\x00" * 1000, bytes(rng.integers(0, 256, 500)),
                 b"abc" + b"\xff" * 300 + b"xy" + b"\x01\x01",
                 bytes(rng.integers(0, 3, 2000))):
        enc = dicom._packbits_encode(case)
        assert enc == jd._packbits_encode(case)
        assert dicom._packbits_decode(enc, len(case)) == case


def _raises_as_jax(folder):
    """Both readers raise the same error on ``folder``."""
    with pytest.raises(ValueError) as ref:
        jd.read_dicom_series(folder)
    with pytest.raises(ValueError, match=re.escape(str(ref.value))):
        dicom.read_dicom_series(folder)


def test_non_advancing_positions_raise(tmp_path):
    data = _data("int16", 2)
    for s in ("a", "b"):
        dicom.write_dicom_series(str(tmp_path / s), data, _frame())
    for f in os.listdir(tmp_path / "b"):
        shutil.copy(tmp_path / "b" / f, tmp_path / "a" / f"b_{f}")
    _raises_as_jax(str(tmp_path / "a"))


def test_truncated_encapsulated_data_raises(tmp_path):
    dicom.write_dicom_series(str(tmp_path), _data("int16", 3), _frame(), compress="rle")
    p = tmp_path / "slice_0002.dcm"
    p.write_bytes(p.read_bytes()[:-8])  # the sequence delimiter is gone
    _raises_as_jax(str(tmp_path))


def test_empty_folder_raises(tmp_path):
    _raises_as_jax(str(tmp_path))


# ---------------------------------------------------------------------------
# files built element by element: lossy JPEG, multi-fragment and multi-frame
# ---------------------------------------------------------------------------

def _encapsulated(fragments, bot=b""):
    out = struct.pack("<HH2sHI", 0x7FE0, 0x0010, b"OB", 0, 0xFFFFFFFF)
    for item in [bot] + list(fragments):
        out += struct.pack("<HHI", 0xFFFE, 0xE000, len(item)) + item
    return out + struct.pack("<HHI", 0xFFFE, 0xE0DD, 0)


def _write_file(path, pixels, transfer, rows, cols, bits=16, signed=True,
                frames=None, slice_spacing=None, pos=(3.0, -7.0, 11.0)):
    """One part-10 file: ``pixels`` are native bytes or a list of
    encapsulated fragments (then ``(fragments, basic offset table)``)."""
    e = dicom._elem
    body = []
    if slice_spacing is not None:
        body.append(e(0x0018, 0x0088, b"DS", dicom._ds(slice_spacing)))
    body += [e(0x0020, 0x0032, b"DS", dicom._ds(*pos)),
             e(0x0020, 0x0037, b"DS", b"1\\0\\0\\0\\1\\0"),
             e(0x0028, 0x0002, b"US", struct.pack("<H", 1))]
    if frames is not None:
        body.append(e(0x0028, 0x0008, b"IS", str(frames).encode()))
    body += [e(0x0028, 0x0010, b"US", struct.pack("<H", rows)),
             e(0x0028, 0x0011, b"US", struct.pack("<H", cols)),
             e(0x0028, 0x0030, b"DS", dicom._ds(0.8, 0.7)),
             e(0x0028, 0x0100, b"US", struct.pack("<H", bits)),
             e(0x0028, 0x0103, b"US", struct.pack("<H", int(signed)))]
    if isinstance(pixels, tuple):
        body.append(_encapsulated(*pixels))
    else:
        body.append(e(0x7FE0, 0x0010, b"OW", pixels))
    tail = e(0x0002, 0x0010, b"UI", transfer.encode())
    meta = e(0x0002, 0x0000, b"UL", struct.pack("<I", len(tail))) + tail
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM" + meta + b"".join(body))


def _split(blob, n):
    """``blob`` as ``n`` even-length fragments."""
    cut = [2 * (len(blob) * k // (2 * n)) for k in range(n)] + [len(blob)]
    return [blob[cut[k]:cut[k + 1]] for k in range(n)]


def test_lossy_jpeg_raises(tmp_path):
    _write_file(str(tmp_path / "a.dcm"), ([b"\xff\xd8\xff\xd9"], b""),
                "1.2.840.10008.1.2.4.50", 4, 4)
    _raises_as_jax(str(tmp_path))


def test_multi_fragment_jpeg_frame(tmp_path):
    img = _data("int16", 4, (1, 24, 20))[0]
    blob = encode_jpeg_lossless(img.view(np.uint16), precision=16)
    blob += b"\x00" * (len(blob) % 2)
    _write_file(str(tmp_path / "a.dcm"), (_split(blob, 3), b""),
                "1.2.840.10008.1.2.4.70", 24, 20)
    got, frame = dicom.read_dicom_series(str(tmp_path))
    ref, ref_frame = jd.read_dicom_series(str(tmp_path))
    np.testing.assert_array_equal(got[0], img)
    np.testing.assert_array_equal(got, ref)
    assert frame.to_dict() == ref_frame.to_dict()


@pytest.mark.parametrize("syntax", ["native", "rle", "jpeg_lossless"])
def test_multi_frame_file_reads_every_frame(tmp_path, syntax):
    """A fault of the JAX reader fixed in the port: it kept the first frame
    of a multi-frame file. The port stacks every frame, stepped by
    SpacingBetweenSlices, into the volume the same slices give as a
    series."""
    data = _data("int16", 5, (4, 12, 10))
    series = str(tmp_path / "series")
    dicom.write_dicom_series(series, data, Frame(np.array([3.0, -7.0, 11.0]),
                                                 np.array([0.7, 0.8, 2.5]), np.eye(3)))
    if syntax == "native":
        pixels, transfer = data.tobytes(), dicom._EXPLICIT_LE
    elif syntax == "rle":  # one fragment per frame, empty offset table
        pixels = ([dicom._rle_encode_frame(s) for s in data], b"")
        transfer = dicom._RLE_LOSSLESS
    else:  # two fragments per frame, placed by the basic offset table
        frags, bot, at = [], [], 0
        for s in data:
            blob = encode_jpeg_lossless(s.view(np.uint16), precision=16)
            bot.append(at)
            for part in _split(blob + b"\x00" * (len(blob) % 2), 2):
                frags.append(part)
                at += 8 + len(part)
        pixels = (frags, struct.pack(f"<{len(bot)}I", *bot))
        transfer = dicom._JPEG_LOSSLESS_SV1
    multi = str(tmp_path / "multi" / "mf.dcm")
    _write_file(multi, pixels, transfer, 12, 10, frames=4, slice_spacing=2.5)
    got, frame = dicom.read_dicom_series(os.path.dirname(multi))
    ref, ref_frame = dicom.read_dicom_series(series)
    assert got.shape == (4, 12, 10)
    np.testing.assert_array_equal(got, data)
    np.testing.assert_array_equal(got, ref)
    assert frame.to_dict() == ref_frame.to_dict()


def test_multi_frame_without_slice_spacing_raises(tmp_path):
    data = _data("int16", 6, (3, 6, 5))
    _write_file(str(tmp_path / "mf.dcm"), data.tobytes(), dicom._EXPLICIT_LE,
                6, 5, frames=3)
    with pytest.raises(ValueError, match="SpacingBetweenSlices"):
        dicom.read_dicom_series(str(tmp_path))


def test_8bit_jpeg_sample_above_255_raises(tmp_path):
    """A fault of the JAX reader fixed in the port: it wrapped 8-bit JPEG
    Lossless samples above 255 silently. The port raises; samples that fit
    read as they are, as in JAX."""
    rng = np.random.default_rng(7)
    fits = rng.integers(0, 256, (6, 8)).astype(np.uint16)
    blob = encode_jpeg_lossless(fits, precision=8)
    _write_file(str(tmp_path / "ok" / "a.dcm"), ([blob + b"\x00" * (len(blob) % 2)], b""),
                dicom._JPEG_LOSSLESS_SV1, 6, 8, bits=8, signed=False)
    got, _ = dicom.read_dicom_series(str(tmp_path / "ok"))
    np.testing.assert_array_equal(got[0], fits)
    np.testing.assert_array_equal(got, jd.read_dicom_series(str(tmp_path / "ok"))[0])
    wide = fits * 16  # up to 4080: a 12-bit stream in an 8-bit file
    blob = encode_jpeg_lossless(wide, precision=12)
    _write_file(str(tmp_path / "bad" / "a.dcm"), ([blob + b"\x00" * (len(blob) % 2)], b""),
                dicom._JPEG_LOSSLESS_SV1, 6, 8, bits=8, signed=False)
    with pytest.raises(ValueError, match="does not fit 8 allocated bits"):
        dicom.read_dicom_series(str(tmp_path / "bad"))
