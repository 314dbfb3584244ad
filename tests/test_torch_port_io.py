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


EXTS = [".nii", ".nii.gz", ".mha", ".mhd", ".hdr", ".img.gz"]
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


def test_unported_formats_fail_loudly(tmp_path):
    with pytest.raises(NotImplementedError):
        read_image(str(tmp_path / "v.nrrd"))
    with pytest.raises(NotImplementedError):
        read_image(str(tmp_path))  # a DICOM series directory
