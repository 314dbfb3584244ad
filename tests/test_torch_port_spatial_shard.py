"""Spatially sharded inference (z-slabs, halo exchange): the port's
SpatialShardedInferer (every shard on the CPU) against the JAX package's on
meshes of the 8 virtual CPU devices, and the port's segmentation() with
spatial_shard against JAX's and against its own SLAB path.

Tolerances are tests/test_spatial_shard.py's: 1e-5 in probabilities for
the blur net, 2e-5 for a V-Net, masks equal; the public path's mask on
>= 99.9% of voxels of the SLAB path's (that path's 3-D weight map floors
at 1e-3 of its peak, the z-only profile does not).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation3d_tpu.core import spatial_shard as js
from segmentation3d_tpu.core.seg_infer import segmentation as jax_segmentation
from segmentation3d_tpu.io import read_image as jax_read
from segmentation3d_tpu.parallel import make_mesh
from segmentation3d_tpu.utils import model_io as jax_io
from segmentation3d_tpu.utils.normalizer import FixedNormalizer as JaxFixed
from segmentation3d_tpu_torch.cli.seg_infer import main as seg_infer
from segmentation3d_tpu_torch.core import spatial_shard as ts
from segmentation3d_tpu_torch.core.seg_infer import module_forward, segmentation
from segmentation3d_tpu_torch.io import Volume, read_image, write_image
from segmentation3d_tpu_torch.ops.geometry import Frame
from test_torch_port_checkpoint import KW as NET_KW, jax_net, seeded_variables

BASE2 = {"base_channels": 2}


class _BlurNet:
    """tests/test_spatial_shard.py's fake net: the class-1 probability is a
    3-voxel z-average, so a wrong halo plane would show."""

    def apply(self, variables, x, train=False):
        v = x[..., :1]
        blur = (jnp.roll(v, 1, axis=1) + v + jnp.roll(v, -1, axis=1)) / 3.0
        return jnp.concatenate([1.0 - blur, blur], axis=-1)


def blur(x):
    v = x[..., :1]
    b = (torch.roll(v, 1, 1) + v + torch.roll(v, -1, 1)) / 3.0
    return torch.cat([1.0 - b, b], -1)


def _vol(shape, seed=0):
    return np.random.default_rng(seed).uniform(0.2, 0.8, shape + (1,)).astype(np.float32)


def _cpu(n):
    return [torch.device("cpu")] * n


@pytest.mark.parametrize("D,pz,sz", [(64, 16, 12), (32, 16, 8), (27, 8, 8),
                                     (16, 16, 4), (10, 16, 4), (100, 24, 7)])
def test_z_starts_match_jax(D, pz, sz):
    np.testing.assert_array_equal(ts._z_starts(D, pz, sz), js._z_starts(D, pz, sz))


@pytest.mark.parametrize("pz", [1, 8, 16, 64])
@pytest.mark.parametrize("kind", ["gaussian", "constant"])
def test_z_weight_profile_matches_jax(pz, kind):
    np.testing.assert_array_equal(ts.z_weight_profile(pz, kind),
                                  js.z_weight_profile(pz, kind))


# (depth, slab, stride): 32/16 over 8 shards is Dl = 4, four halo hops;
# depth 27 pads to a multiple of the shard count
CASES = [(32, 16, 8), (27, 8, 8), (27, 16, 6)]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("D,pz,sz", CASES)
def test_blur_net_matches_jax(n, D, pz, sz):
    vol = _vol((D, 16, 16), seed=D)
    kw = dict(slab_z=pz, num_classes=2, stride_z=sz, blend="gaussian")
    m, p = ts.SpatialShardedInferer(blur, devices=_cpu(n), **kw)(
        torch.from_numpy(vol), return_prob=True)
    jm, jp = js.SpatialShardedInferer(_BlurNet(), mesh=make_mesh(n), **kw)(
        None, jnp.asarray(vol), return_prob=True)
    assert m.shape == (D, 16, 16) and m.dtype == torch.uint8
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=1e-5)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))


@pytest.fixture(scope="module")
def base2():
    """A seeded base-2 V-Net (the default depths) in both packages."""
    v, net = seeded_variables(kw=BASE2, seed=1)
    return jax_net(kw=BASE2), v, net


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("D", [32, 27])
def test_vnet_matches_jax(base2, n, D):
    jnet, v, net = base2
    vol = _vol((D, 16, 16), seed=7)
    kw = dict(slab_z=16, num_classes=2, stride_z=8, blend="gaussian")
    m, p = ts.SpatialShardedInferer(module_forward(net, torch.float32),
                                    devices=_cpu(n), **kw)(
        torch.from_numpy(vol), return_prob=True)
    jm, jp = js.SpatialShardedInferer(jnet, mesh=make_mesh(n), **kw)(
        v, jnp.asarray(vol), return_prob=True)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=2e-5)
    # a voxel may flip only at an argmax near-tie of JAX's probabilities
    differ = m.numpy() != np.asarray(jm)
    assert np.all(np.abs(np.diff(np.asarray(jp), axis=-1))[..., 0][differ] < 4e-5)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """tests/test_spatial_shard.py's public-path case: a JAX-written base-2
    checkpoint (seeded weights) and a 48x32x32
    normal volume."""
    d = tmp_path_factory.mktemp("spatial")
    variables, _ = seeded_variables(kw=BASE2, seed=0)
    model_dir = str(d / "model")
    jax_io.save_checkpoint(
        model_dir, 0, 0, variables, net_name="vnet", max_stride=16,
        in_channels=1, out_channels=2, spacing=[1.0, 1.0, 1.0],
        interpolation="LINEAR", crop_normalizers=[JaxFixed(mean=0.0, stddev=1.0)],
        extra={"net_kwargs": BASE2})
    img = np.random.default_rng(11).normal(0.0, 1.0, (48, 32, 32)).astype(np.float32)
    src = str(d / "case.nii.gz")
    write_image(Volume(img, Frame.identity()), src)
    return d, model_dir, src


KW = dict(seg_name="seg.nii.gz", partition_type="SLAB", partition_size=[16, 16, 16],
          partition_stride=[8, 8, 8], blend="constant", shape_bucket=16)


def test_segmentation_matches_jax(case):
    d, model_dir, src = case
    jax_segmentation(src, model_dir, str(d / "jax8"), num_devices=8,
                     spatial_shard=True, **KW)
    segmentation(src, model_dir, str(d / "port8"), device=_cpu(8),
                 spatial_shard=True, **KW)
    segmentation(src, model_dir, str(d / "slab"), device="cpu", **KW)
    ref = jax_read(str(d / "jax8" / "case" / "seg.nii.gz")).data
    got = read_image(str(d / "port8" / "case" / "seg.nii.gz")).data
    slab = read_image(str(d / "slab" / "case" / "seg.nii.gz")).data
    assert got.shape == ref.shape == (48, 32, 32)
    assert 0.05 < np.mean(ref == 1) < 0.95  # both labels present
    assert np.mean(got == ref) >= 0.999
    assert np.mean(got == slab) >= 0.999


def test_cli_spatial_shard_on_cpu_shards(case):
    """``-g -1 --num_devices 4 --spatial_shard`` gives the library call's mask."""
    d, model_dir, src = case
    seg_infer(["-i", src, "-m", model_dir, "-o", str(d / "cli4"), "-g", "-1",
               "-n", "seg.nii.gz", "--num_devices", "4", "--spatial_shard",
               "--partition_type", "SLAB", "--partition_size", "16", "16", "16",
               "--partition_stride", "8", "8", "8", "--blend", "constant"])
    segmentation(src, model_dir, str(d / "lib4"), device=_cpu(4), spatial_shard=True,
                 **dict(KW, shape_bucket=64))
    a = read_image(str(d / "cli4" / "case" / "seg.nii.gz")).data
    b = read_image(str(d / "lib4" / "case" / "seg.nii.gz")).data
    np.testing.assert_array_equal(a, b)


RAILS = [
    ("no_mesh", dict(spatial_shard=True), {}),
    ("not_slab", dict(num_devices=8, spatial_shard=True), {"partition_type": "SIZE"}),
    ("tta", dict(num_devices=8, spatial_shard=True, tta="x"), {}),
    ("ensemble", dict(num_devices=8, spatial_shard=True), {"ensemble": True}),
]


@pytest.mark.parametrize("tag,opts,extra", RAILS, ids=[r[0] for r in RAILS])
def test_guard_rails_raise_jax_messages(case, tag, opts, extra):
    d, model_dir, src = case
    kw = dict(KW, partition_type=extra.get("partition_type", "SLAB"))
    models = [model_dir, model_dir] if extra.get("ensemble") else model_dir
    with pytest.raises(ValueError) as ref:
        jax_segmentation(src, models, str(d / f"rail_j_{tag}"), **opts, **kw)
    port_opts = dict(opts)
    n = port_opts.pop("num_devices", 1)
    with pytest.raises(ValueError) as got:
        segmentation(src, models, str(d / f"rail_p_{tag}"), device=_cpu(n),
                     **port_opts, **kw)
    assert str(got.value) == str(ref.value)


def test_int8_spatial_matches_int8_slab(tmp_path):
    """``--int8`` inside 4 z-shards (the int8 forward's plain versions)
    against the unsharded int8 SLAB path: >= 99.9% of voxels (the weight
    profiles differ as above). A base-4 net: the int8 GEMMs need channel
    counts that are multiples of 8."""
    from segmentation3d_tpu.utils.normalizer import AdaptiveNormalizer
    v, _ = seeded_variables(seed=5)
    model_dir = str(tmp_path / "model")
    jax_io.save_checkpoint(model_dir, 1, 0, v, "vnet", 4, 1, 2, [1.0, 1.0, 1.0],
                           "LINEAR", [AdaptiveNormalizer()],
                           extra={"net_kwargs": dict(NET_KW)})
    z, y, x = np.mgrid[0:40, 0:32, 0:32]
    img = np.where((z - 20) ** 2 + (y - 15) ** 2 + (x - 17) ** 2 < 120, 200.0, 0.0)
    img = (img + np.random.default_rng(2).normal(0, 20, img.shape)).astype(np.float32)
    src = str(tmp_path / "case.nii.gz")
    write_image(Volume(img, Frame.identity()), src)
    kw = dict(KW, partition_stride=[10, 10, 10], quant="int8", dtype=torch.bfloat16)
    segmentation(src, model_dir, str(tmp_path / "sp"), device=_cpu(4),
                 spatial_shard=True, **kw)
    segmentation(src, model_dir, str(tmp_path / "slab"), device="cpu", **kw)
    a = read_image(str(tmp_path / "sp" / "case" / "seg.nii.gz")).data
    b = read_image(str(tmp_path / "slab" / "case" / "seg.nii.gz")).data
    assert 0.05 < np.mean(b == 1) < 0.95
    assert np.mean(a == b) >= 0.999
    assert os.path.isfile(str(tmp_path / "sp" / "case" / "seg.nii.gz"))
