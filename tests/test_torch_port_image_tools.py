"""The port's small parity surface against the JAX package, on the cases of
tests/test_image_tools.py: ``utils/image_tools.py`` (tensors are torch
tensors in the channels-last [D,H,W,C] layout), ``models.create_network`` /
``max_stride_of``, ``Volume.astype`` and the top-level entry aliases."""
import subprocess
import sys

import numpy as np
import pytest
import torch

from segmentation3d_tpu import models as jax_models
from segmentation3d_tpu.io import Volume as JaxVolume
from segmentation3d_tpu.ops.geometry import Frame as JaxFrame
from segmentation3d_tpu.utils import image_tools as jit_
from segmentation3d_tpu_torch import models
from segmentation3d_tpu_torch.io import Volume
from segmentation3d_tpu_torch.ops.geometry import Frame
from segmentation3d_tpu_torch.utils import image_tools as it


def _pair(shape=(12, 14, 16), spacing=(1, 1, 1), origin=(0, 0, 0), seed=0):
    """The same seeded volume as a port Volume and a JAX Volume."""
    data = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return (Volume(data.copy(), Frame.identity(spacing=spacing, origin=origin)),
            JaxVolume(data.copy(), JaxFrame.identity(spacing=spacing, origin=origin)))


def _same(vol, jvol, atol=1e-5):
    assert vol.data.shape == jvol.data.shape
    assert vol.data.dtype == np.asarray(jvol.data).dtype
    np.testing.assert_allclose(vol.data, np.asarray(jvol.data), atol=atol)
    assert vol.frame.to_dict() == pytest.approx(jvol.frame.to_dict())


def test_get_set_frame():
    v, jv = _pair()
    f2 = dict(origin=(1, 2, 3), spacing=(2, 2, 2), direction=np.eye(3))
    it.set_image_frame(v, Frame(**f2))
    jit_.set_image_frame(jv, JaxFrame(**f2))
    assert it.get_image_frame(v).to_dict() == jit_.get_image_frame(jv).to_dict()


@pytest.mark.parametrize("interp", ["LINEAR", "NN"])
def test_crop_image(interp):
    v, jv = _pair((21, 21, 21), spacing=(0.8, 1.0, 1.2))
    kw = dict(center_world=(8.3, 10.1, 11.6), crop_size_xyz=(7, 5, 6),
              crop_spacing_xyz=(1.1, 0.9, 1.3), interpolation=interp, fill=-2.0)
    _same(it.crop_image(v, **kw), jit_.crop_image(jv, **kw))
    # the reference test's impulse at the centre
    v, _ = _pair((21, 21, 21))
    v.data[:] = 0.0
    v.data[10, 10, 10] = 5.0
    crop = it.crop_image(v, center_world=(10, 10, 10), crop_size_xyz=(5, 5, 5),
                         crop_spacing_xyz=(1, 1, 1))
    assert crop.data.shape == (5, 5, 5) and crop.data[2, 2, 2] == 5.0


@pytest.mark.parametrize("max_stride", [1, 16])
def test_resample_spacing(max_stride):
    v, jv = _pair((20, 20, 20), spacing=(2, 2, 2), origin=(3, -1, 2))
    out = it.resample_spacing(v, (1, 1, 1), max_stride=max_stride)
    _same(out, jit_.resample_spacing(jv, (1, 1, 1), max_stride=max_stride))
    assert all(s % max_stride == 0 for s in out.data.shape)


def test_resample_to_frame():
    v, jv = _pair((10, 10, 10))
    f = dict(origin=(1, 1, 1), spacing=(1, 1, 1), direction=np.eye(3))
    out = it.resample(v, Frame(**f), (8, 8, 8))
    _same(out, jit_.resample(jv, JaxFrame(**f), (8, 8, 8)))
    np.testing.assert_allclose(out.data, v.data[1:9, 1:9, 1:9], atol=1e-4)


@pytest.mark.parametrize("size,stride,max_stride",
                         [((32, 32, 32), (32, 32, 32), 1),
                          ((30, 20, 24), (16, 10, 8), 16)])
def test_partition_by_fixed_size(size, stride, max_stride):
    v, jv = _pair((64, 64, 64))
    boxes = it.image_partition_by_fixed_size(v, size, stride, max_stride)
    ref = jit_.image_partition_by_fixed_size(jv, size, stride, max_stride)
    assert len(boxes) == len(ref)
    for (s, e), (rs, re) in zip(boxes, ref):
        np.testing.assert_array_equal(s, rs)
        np.testing.assert_array_equal(e, re)


def test_tensor_conversions():
    v, jv = _pair((4, 5, 6))
    t = it.convert_image_to_tensor(v)
    assert isinstance(t, torch.Tensor) and t.shape == (4, 5, 6, 1)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jit_.convert_image_to_tensor(jv)))
    t2 = it.convert_image_to_tensor([v, v])
    assert t2.shape == (4, 5, 6, 2)
    np.testing.assert_array_equal(t2.numpy(),
                                  np.asarray(jit_.convert_image_to_tensor([jv, jv])))
    t[0, 0, 0, 0] = 123.0  # a copy, not a view of the volume
    assert v.data[0, 0, 0] != 123.0
    back = it.convert_tensor_to_image(t2[..., :1], v.frame, dtype=np.float64)
    assert back.data.dtype == np.float64
    np.testing.assert_allclose(back.data, v.data)
    multi = it.convert_tensor_to_image(t2, v.frame)
    assert isinstance(multi, list) and len(multi) == 2
    jmulti = jit_.convert_tensor_to_image(np.asarray(t2), jv.frame)
    for a, b in zip(multi, jmulti):
        np.testing.assert_array_equal(a.data, b.data)


def test_copy_image_is_deep():
    v, _ = _pair()
    c = it.copy_image(v)
    c.data[0, 0, 0] = 123.0
    assert v.data[0, 0, 0] != 123.0


@pytest.mark.parametrize("name", ["pick_largest_connected_component",
                                  "remove_small_connected_component"])
def test_component_reexports(name):
    rng = np.random.default_rng(1)
    mask = (rng.random((12, 12, 12)) > 0.6).astype(np.uint8) * \
        rng.integers(1, 3, (12, 12, 12)).astype(np.uint8)
    args = (mask,) if name.startswith("pick") else (mask, 3)
    np.testing.assert_array_equal(getattr(it, name)(*args), getattr(jit_, name)(*args))


@pytest.mark.parametrize("name,kw", [("vnet", {}), ("vbnet", {}),
                                     ("vnet", dict(base_channels=4, act="prelu",
                                                   down_convs=(1, 2), up_convs=(2, 1)))])
def test_create_network_and_max_stride(name, kw):
    net = models.create_network(name, 1, 3, **kw)
    jnet = jax_models.create_network(name, 1, 3, **kw)
    assert net.bottleneck == jnet.bottleneck and net.act == jnet.act
    assert (net.in_channels, net.out_channels) == (1, 3)
    assert net.max_stride() == jnet.max_stride()
    assert models.max_stride_of(name) == jax_models.max_stride_of(name) == 16


def test_volume_astype():
    v, jv = _pair()
    a, b = v.astype(np.int16), jv.astype(np.int16)
    assert isinstance(a, Volume) and a.frame is v.frame
    np.testing.assert_array_equal(a.data, b.data)
    assert a.data.dtype == np.int16


@pytest.mark.parametrize("alias", ["seg_infer", "seg_train"])
def test_entry_aliases(alias):
    """``python -m segmentation3d_tpu_torch.<alias> --help`` runs the CLI."""
    res = subprocess.run([sys.executable, "-m", f"segmentation3d_tpu_torch.{alias}",
                          "--help"], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "PyTorch/CUDA port" in res.stdout
