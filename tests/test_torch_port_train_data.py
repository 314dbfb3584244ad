"""The port's training data path against the JAX package's on the CPU:
``crop_at_world_center``, ``elastic_warp`` for a given field, the dataset's
crops under every sampling method with every augmentation on, the noise
stream, and config loading through both packages in one process.

Bars: crop frames (so the crop centres) equal to 1e-9 mm; image crops
within 1e-4 (float32 resampling and normalization in other orders); label
crops equal; ``elastic_warp``'s dense field within 1e-5 of
``jax.image.resize``'s (measured <= 2e-6), its image within 1e-4, its
labels equal. Noise: the port draws it from its own ``torch.Generator``
(the JAX package from a PRNG key), so only its statistics are held, and the
next crop's centre must still be JAX's.
"""
import itertools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crop_boxes import box_bounds, box_voxels
from phantoms import make_sphere_case, write_train_config
from segmentation3d_tpu.dataloader.dataset import SegmentationDataset as JaxDataset
from segmentation3d_tpu.ops.elastic import elastic_warp as jax_elastic
from segmentation3d_tpu.ops.geometry import Frame as JaxFrame
from segmentation3d_tpu.ops.resample import crop_at_world_center as jax_crop
from segmentation3d_tpu.utils import normalizer as jax_norm
from segmentation3d_tpu_torch.dataloader.dataset import SegmentationDataset
from segmentation3d_tpu_torch.ops.elastic import dense_field, elastic_warp
from segmentation3d_tpu_torch.ops.geometry import Frame, frame_for_crop
from segmentation3d_tpu_torch.ops.resample import (
    _compose_dst_to_src, crop_at_world_center, resample_exec, source_box)
from segmentation3d_tpu_torch.utils import normalizer as port_norm
from segmentation3d_tpu_torch.utils import tracing
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("data"))
    return [make_sphere_case(d, f"c{i}", shape_zyx=(22, 26, 24),
                             spacing=(1.1, 0.9, 1.3), seed=i) for i in range(2)]


def _rotated(frame_cls):
    c, s = np.cos(0.3), np.sin(0.3)
    direction = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return frame_cls(np.array([-3.0, 2.0, 1.5]), np.array([1.2, 0.8, 1.5]), direction)


@pytest.mark.parametrize("rotated", [False, True])
@pytest.mark.parametrize("interp", ["LINEAR", "NN"])
def test_crop_at_world_center_matches_jax(rotated, interp):
    rng = np.random.default_rng(1)
    data = rng.normal(size=(14, 15, 16)).astype(np.float32)
    if interp == "NN":
        data = rng.integers(0, 3, size=data.shape).astype(np.int32)
    jf = _rotated(JaxFrame) if rotated else JaxFrame.identity((1.2, 0.8, 1.5))
    pf = _rotated(Frame) if rotated else Frame.identity((1.2, 0.8, 1.5))
    center = np.array([6.0, 5.5, 9.0])
    want, wf = jax_crop(jnp.asarray(data), jf, center, (8, 9, 10),
                        (1.0, 1.1, 0.9), interp=interp)
    got, gf = crop_at_world_center(torch.from_numpy(data), pf, center, (8, 9, 10),
                                   (1.0, 1.1, 0.9), interp=interp)
    assert np.allclose(gf.origin, wf.origin, atol=1e-9)
    assert got.dtype == (torch.float32 if interp == "LINEAR" else torch.int32)
    if interp == "NN":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def _box_centres(frame, size_zyx, rng):
    """Source-index centres on each axis inside, straddling either face and
    wholly outside (every mix of them: faces, edges, corners), jittered."""
    top = np.asarray(size_zyx, np.float64)[::-1] - 1.0
    for fx, fy, fz in itertools.product((0.5, 0.0, 1.0, -1.0, 2.0), repeat=3):
        idx = np.array([fx, fy, fz]) * top + rng.uniform(-1.0, 1.0, 3)
        yield frame.index_to_world(idx)


@pytest.mark.parametrize("path", ["axis", "rotated", "rotated_gather"])
@pytest.mark.parametrize("interp", ["LINEAR", "NN"])
def test_box_crop_equals_the_whole_volume_crop(path, interp):
    """A crop read from its source box, against the same crop of the whole
    volume: labels (NN) bit for bit, images within float32 summation order.
    ``rotated_gather`` runs the rotated crop through the gather core."""
    rng = np.random.default_rng(3)
    shape, size, spacing = (14, 15, 16), (8, 9, 10), (1.0, 1.1, 0.9)
    data = rng.normal(size=shape).astype(np.float32)
    if interp == "NN":
        data = rng.integers(0, 3, size=shape).astype(np.int32)
    whole = torch.from_numpy(data)
    frame = Frame.identity((1.2, 0.8, 1.5)) if path == "axis" else _rotated(Frame)
    for center in _box_centres(frame, shape, rng):
        box = source_box(frame, shape, center, size, spacing)
        crop_frame = frame_for_crop(frame, center, size, spacing)
        lo, hi = box_bounds(frame, shape, crop_frame, size)
        assert (box.lo, box.hi) == (tuple(lo), tuple(hi))
        part = whole[box.slices]
        if path == "rotated_gather":
            m = np.asarray(_compose_dst_to_src(frame, crop_frame)[:3], np.float32)
            want = resample_exec(whole, "aff", m, size[::-1], interp)
            got = resample_exec(part, "aff", m, size[::-1], interp, box=box)
        else:
            want, _ = crop_at_world_center(whole, frame, center, size, spacing, interp)
            got, _ = crop_at_world_center(part, frame, center, size, spacing, interp,
                                          box=box)
        assert got.dtype == want.dtype
        if interp == "NN":
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def big_case(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("big"))
    return [make_sphere_case(d, "big", shape_zyx=(40, 56, 52),
                             spacing=(1.1, 0.9, 1.3), seed=4)]


def _stage_run(big_case, cache_gb):
    ims, segs = [c[0] for c in big_case], [c[1] for c in big_case]
    ds = SegmentationDataset(
        (ims, segs), num_classes=2, spacing=(1.0, 1.0, 1.0), crop_size=(16, 16, 12),
        sampling_method="MIX", random_translation=(30.0, 30.0, 30.0), seed=9,
        device_cache_gb=cache_gb, crop_normalizers=[port_norm.FixedNormalizer(
            mean=0.0, stddev=200.0, clip=False)])
    tracing.take()
    with profile(activities=[ProfilerActivity.CPU]):
        batch = ds.batch([0] * 6)
    return ds, batch, tracing.take().counters


def test_a_cache_miss_uploads_only_the_source_box(big_case):
    ds0, (im0, seg0, frames, _), counted = _stage_run(big_case, 0.0)
    case = ds0.cases[0]
    boxes = [box_voxels(v.frame, v.data.shape, f, (16, 16, 12))
             for f in frames for v in (case.images[0], case.seg)]
    assert counted["train.stage_miss"] == 6
    assert counted["train.stage_bytes"] == 4 * sum(boxes)
    assert max(boxes) * 8 < case.nbytes
    ds1, (im1, seg1, frames1, _), resident = _stage_run(big_case, 10.0)
    assert "train.stage_miss" not in resident and "train.stage_bytes" not in resident
    assert ds1.cases[0].dev_images is not None
    assert [f.origin.tolist() for f in frames1] == [f.origin.tolist() for f in frames]
    torch.testing.assert_close(im1, im0, rtol=1e-6, atol=1e-6)
    assert torch.equal(seg1, seg0)


def test_elastic_warp_matches_jax():
    rng = np.random.default_rng(2)
    image = rng.normal(size=(12, 14, 16, 2)).astype(np.float32)
    seg = rng.integers(0, 3, size=(12, 14, 16)).astype(np.int32)
    disp = rng.normal(0.0, 1.5, size=(4, 4, 4, 3)).astype(np.float32)
    field = np.asarray(jax.image.resize(jnp.asarray(disp), (12, 14, 16, 3),
                                        method="trilinear"))
    np.testing.assert_allclose(dense_field(torch.from_numpy(disp), (12, 14, 16)).numpy(),
                               field, atol=1e-5)
    wi, ws = jax_elastic(jnp.asarray(image), jnp.asarray(seg), jnp.asarray(disp))
    gi, gs = elastic_warp(torch.from_numpy(image), torch.from_numpy(seg),
                          torch.from_numpy(disp))
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), atol=1e-4)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


AUG = dict(random_flip=True, random_rot90=True, random_intensity_scale=(0.9, 1.1),
           random_intensity_shift=(-0.1, 0.1), random_elastic_magnitude=1.0,
           random_elastic_grid=3, random_elastic_prob=0.7)


def _datasets(cases, method, norm, noise=0.0, **aug):
    ims = [c[0] for c in cases]
    segs = [c[1] for c in cases]
    kw = dict(num_classes=2, spacing=(1.0, 1.0, 1.0), crop_size=(16, 16, 12),
              sampling_method=method, random_translation=(3.0, 3.0, 3.0),
              seed=5, random_noise_std=noise, **aug)
    jd = JaxDataset((ims, segs), crop_normalizers=[getattr(jax_norm, norm[0])(**norm[1])],
                    **kw)
    pd = SegmentationDataset((ims, segs), crop_normalizers=[getattr(port_norm, norm[0])(**norm[1])],
                             **kw)
    return jd, pd


@pytest.mark.parametrize("method,norm", [
    ("GLOBAL", ("FixedNormalizer", dict(mean=50.0, stddev=150.0, clip=True))),
    ("MASK", ("AdaptiveNormalizer", dict(min_p=0.01, max_p=0.99, clip=True))),
    ("CENTER", ("FixedNormalizer", dict(mean=0.0, stddev=200.0, clip=False))),
    ("MIX", ("FixedNormalizer", dict(mean=50.0, stddev=150.0, clip=True))),
])
def test_dataset_crops_match_jax(cases, method, norm):
    jd, pd = _datasets(cases, method, norm, **AUG)
    for i in [0, 1, 1, 0, 1, 0]:
        wi, ws, wf, wn = jd[i]
        gi, gs, gf, gn = pd[i]
        assert gn == wn
        assert np.allclose(gf.origin, wf.origin, atol=1e-9)
        assert np.allclose(gf.spacing, wf.spacing) and np.allclose(gf.direction, wf.direction)
        assert gi.shape == wi.shape == (12, 16, 16, 1)
        np.testing.assert_allclose(gi.numpy(), np.asarray(wi), atol=1e-4)
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    assert pd.rng.bit_generator.state == jd.rng.bit_generator.state


def test_noise_statistics_and_stream(cases):
    norm = ("FixedNormalizer", dict(mean=50.0, stddev=150.0, clip=True))
    jd, pd = _datasets(cases, "MASK", norm, noise=0.1)
    _, quiet = _datasets(cases, "MASK", norm)
    noisy, q = pd[0], quiet[0]
    residual = (noisy[0] - q[0]).numpy()
    assert abs(residual.mean()) < 0.01 and abs(residual.std() - 0.1) < 0.01
    np.testing.assert_array_equal(noisy[1].numpy(), q[1].numpy())
    jd[0]
    # the noise never touched the numpy stream: the next centre is JAX's
    assert np.allclose(pd[1][2].origin, jd[1][2].origin, atol=1e-9)
    assert pd.rng.bit_generator.state == jd.rng.bit_generator.state


def test_batch_stacks_items(cases):
    _, pd = _datasets(cases, "CENTER", ("FixedNormalizer", dict(mean=0.0, stddev=1.0)))
    images, segs, frames, names = pd.batch([0, 1, 1])
    assert images.shape == (3, 12, 16, 16, 1) and segs.shape == (3, 12, 16, 16)
    assert len(frames) == 3
    assert names == [pd.cases[i].name for i in (0, 1, 1)]


SHIM = r"""
import sys
from segmentation3d_tpu.utils.file_io import load_config as jax_load
from segmentation3d_tpu_torch.utils.file_io import load_config as port_load
order = sys.argv[2]
loaders = [("port", port_load), ("jax", jax_load)]
if order == "jax_first":
    loaders.reverse()
cfgs = {name: fn(sys.argv[1]) for name, fn in loaders}
import segmentation3d_tpu.utils.normalizer as jn
import segmentation3d_tpu_torch.utils.normalizer as pn
pc, jc = cfgs["port"], cfgs["jax"]
assert all(isinstance(n, (pn.FixedNormalizer, pn.AdaptiveNormalizer))
           for n in pc.dataset.crop_normalizers), pc.dataset.crop_normalizers
assert all(isinstance(n, (jn.FixedNormalizer, jn.AdaptiveNormalizer))
           for n in jc.dataset.crop_normalizers), jc.dataset.crop_normalizers
# a second port load after the JAX one still gets port objects
again = port_load(sys.argv[1]).dataset.crop_normalizers[0]
assert isinstance(again, pn.AdaptiveNormalizer), type(again)
print("ok", type(pc).__module__)
"""


@pytest.mark.parametrize("order", ["port_first", "jax_first"])
def test_config_loads_through_both_packages(tmp_path, order):
    """One config file (``from easydict import EasyDict``, ``from
    segmentation3d.utils.normalizer import ...``) loaded through both
    packages in one process, in either order: each gets its own
    normalizer objects."""
    cfg = write_train_config(str(tmp_path / "config.py"), "train.txt",
                             str(tmp_path / "model"))
    res = subprocess.run([sys.executable, "-c", SHIM, cfg, order], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": REPO,
                              "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_template_config_loads_in_the_port():
    from segmentation3d_tpu_torch.utils.file_io import load_config
    cfg = load_config(os.path.join(REPO, "segmentation3d_tpu_torch", "config",
                                   "template_config.py"))
    assert isinstance(cfg.dataset.crop_normalizers[0], port_norm.FixedNormalizer)
    assert cfg.tpu.remat is True and cfg.net.name == "vnet"
