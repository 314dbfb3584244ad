"""Geometry and volume I/O: the port's numpy-only copies give the JAX
package's results, and files written by either package read back to
identical arrays and frames in the other."""
import numpy as np
import pytest

from segmentation3d_tpu.io import Volume as JaxVolume
from segmentation3d_tpu.io import read_image as jax_read
from segmentation3d_tpu.io import write_image as jax_write
from segmentation3d_tpu.ops import geometry as jg
from segmentation3d_tpu_torch.io import Volume, read_image, write_image
from segmentation3d_tpu_torch.ops import geometry as tg


def rotated_frame(port=True):
    th = 0.3
    d = np.array([[np.cos(th), -np.sin(th), 0.0],
                  [np.sin(th), np.cos(th), 0.0], [0.0, 0.0, 1.0]])
    mod = tg if port else jg
    return mod.Frame(np.array([-12.5, 30.0, 7.25]), np.array([0.7, 0.8, 1.5]), d)


@pytest.mark.parametrize("size,psize,stride", [
    ((40, 33, 20), (16, 16, 16), (8, 8, 8)),
    ((96, 96, 64), (96, 96, 32), (96, 96, 16)),
    ((50, 20, 31), (20, 20, 31), (7, 3, 5)),
])
def test_partition_boxes(size, psize, stride):
    np.testing.assert_array_equal(tg.partition_boxes(size, psize, stride),
                                  jg.partition_boxes(size, psize, stride))


def test_partition_boxes_rejects_oversized():
    with pytest.raises(ValueError):
        tg.partition_boxes((8, 8, 8), (16, 8, 8), (8, 8, 8))


@pytest.mark.parametrize("pad", [1, 16, 64])
def test_resampled_frame_and_crop(pad):
    for port_f, jax_f in [(rotated_frame(), rotated_frame(False)),
                          (tg.Frame.identity((0.7, 0.7, 1.25)),
                           jg.Frame.identity((0.7, 0.7, 1.25)))]:
        f1, s1 = tg.resampled_frame(port_f, (512, 512, 240), (1, 1, 1), pad)
        f2, s2 = jg.resampled_frame(jax_f, (512, 512, 240), (1, 1, 1), pad)
        np.testing.assert_array_equal(s1, s2)
        assert f1.to_dict() == f2.to_dict()
        c1 = tg.frame_for_crop(port_f, (3.0, -4.0, 5.0), (32, 16, 8), (1, 2, 3))
        c2 = jg.frame_for_crop(jax_f, (3.0, -4.0, 5.0), (32, 16, 8), (1, 2, 3))
        assert c1.to_dict() == c2.to_dict()


def test_num_partition_by_size():
    for a, b in zip(tg.num_partition_by_size((97, 64, 33), (2, 3, 4)),
                    jg.num_partition_by_size((97, 64, 33), (2, 3, 4))):
        np.testing.assert_array_equal(a, b)


EXTS = [".nii", ".nii.gz", ".mha", ".mhd", ".hdr", ".img.gz", ".nrrd", ".nhdr"]
DTYPES = [np.int16, np.uint8, np.float32]


def _volume(dtype, seed):
    rng = np.random.default_rng(seed)
    data = (rng.normal(size=(7, 9, 11)) * 100).astype(dtype)
    return data


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ext", EXTS)
def test_jax_written_reads_in_port(tmp_path, ext, dtype):
    data = _volume(dtype, 0)
    path = str(tmp_path / f"v{ext}")
    jax_write(JaxVolume(data, rotated_frame(False)), path)
    v = read_image(path)
    ref = jax_read(path)
    np.testing.assert_array_equal(v.data, ref.data)
    np.testing.assert_array_equal(v.data, data)
    assert v.data.dtype == ref.data.dtype
    assert v.frame.to_dict() == ref.frame.to_dict()
    assert v.frame.isclose(rotated_frame(), tol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ext", EXTS)
def test_port_written_reads_in_jax(tmp_path, ext, dtype):
    data = _volume(dtype, 1)
    path = str(tmp_path / f"v{ext}")
    write_image(Volume(data, rotated_frame()), path)
    ref = jax_read(path)
    np.testing.assert_array_equal(ref.data, data)
    assert ref.frame.to_dict() == read_image(path).frame.to_dict()


def test_unknown_extension_raises(tmp_path):
    """Every format the JAX package reads is ported; an unknown extension
    still raises ``ValueError`` both ways, and a directory with no DICOM
    file is no series."""
    with pytest.raises(ValueError, match="unsupported image format"):
        read_image(str(tmp_path / "v.xyz"))
    with pytest.raises(ValueError, match="unsupported image format"):
        write_image(Volume(_volume(np.int16, 0), rotated_frame()), str(tmp_path / "v.xyz"))
    with pytest.raises(ValueError, match="no DICOM files"):
        read_image(str(tmp_path))


def _nrrd_header(lines, sizes=(11, 9, 7)):
    return ("NRRD0004\n# a comment\nkey:=value\ndimension: 3\n"
            f"sizes: {' '.join(map(str, sizes))}\n" + "".join(f"{ln}\n" for ln in lines))


#: NRRD layouts other writers use: (header lines, payload of the int16 voxels)
NRRD_VARIANTS = {
    "ras_space": (["type: short", "space: right-anterior-superior",
                   "space directions: (0.7,0,0) (0,0.8,0) (0,0,1.5)",
                   "space origin: (10,-20,5)", "encoding: raw", "endian: little"], "raw"),
    "big_endian": (["type: int16", "space: left-posterior-superior",
                    "space directions: (0.7,0,0) (0,0.8,0) (0,0,1.5)",
                    "encoding: raw", "endian: big"], "big"),
    "bare_zlib": (["type: short", "spacings: 0.7 0.8 1.5", "encoding: gzip"], "zlib"),
    "gzip_line_skip": (["type: short", "spacings: 0.7 0.8 1.5", "encoding: gzip",
                        "line skip: 1"], "gzip_line"),
    "ascii": (["type: short", "spacings: 0.7 0.8 1.5", "encoding: ascii"], "ascii"),
    "byte_skip_end": (["type: short", "spacings: 0.7 0.8 1.5", "encoding: raw",
                       "byte skip: -1"], "padded"),
}


@pytest.mark.parametrize("name", list(NRRD_VARIANTS))
def test_nrrd_variants_read_as_jax(tmp_path, name):
    import gzip
    import zlib
    data = _volume(np.int16, 2)
    lines, kind = NRRD_VARIANTS[name]
    payload = {"raw": data.tobytes(), "big": data.astype(">i2").tobytes(),
               "zlib": zlib.compress(data.tobytes()),
               "gzip_line": b"skipped line\n" + gzip.compress(data.tobytes()),
               "ascii": " ".join(map(str, data.reshape(-1))).encode(),
               "padded": b"\x07" * 13 + data.tobytes()}[kind]
    path = tmp_path / "v.nrrd"
    path.write_bytes(_nrrd_header(lines).encode() + b"\n" + payload)
    got, ref = read_image(str(path)), jax_read(str(path))
    np.testing.assert_array_equal(got.data, data)
    np.testing.assert_array_equal(got.data, ref.data)
    assert got.data.dtype == ref.data.dtype
    assert got.frame.to_dict() == ref.frame.to_dict()
