"""Resample + normalize: the port's prep_modality vs the JAX package's fused
preprocess program _prep_modality, within 1e-5 (both in float32); NN
resampling of label maps is exact; percentiles follow jnp.percentile."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation3d_tpu.core.seg_infer import _prep_modality
from segmentation3d_tpu.ops import geometry as jg
from segmentation3d_tpu.ops import resample as jr
from segmentation3d_tpu.utils.normalizer import (
    AdaptiveNormalizer as JaxAdaptive, FixedNormalizer as JaxFixed,
)
from segmentation3d_tpu_torch.core.seg_infer import prep_modality
from segmentation3d_tpu_torch.io import Volume
from segmentation3d_tpu_torch.ops import geometry as tg
from segmentation3d_tpu_torch.ops import resample as tr
from segmentation3d_tpu_torch.utils.normalizer import (
    AdaptiveNormalizer, FixedNormalizer, normalizer_from_dict, percentile,
)

CPU = torch.device("cpu")


def frames(kind):
    """(port src frame, jax src frame) of a 20x18x14 (xyz) volume."""
    if kind == "axis":
        args = ((1.5, -2.0, 3.0), (0.7, 0.9, 1.6), np.eye(3))
    else:
        th = 0.25
        d = np.array([[np.cos(th), 0.0, -np.sin(th)], [0.0, 1.0, 0.0],
                      [np.sin(th), 0.0, np.cos(th)]])
        args = ((1.5, -2.0, 3.0), (0.7, 0.9, 1.6), d)
    return tg.Frame(*args), jg.Frame(*args)


def source(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(14, 18, 20)) * 300 + 50).astype(np.int16)


NORMS = {
    "none": (None, None),
    "fixed": (FixedNormalizer(40.0, 200.0, True), JaxFixed(40.0, 200.0, True)),
    "adaptive": (AdaptiveNormalizer(0.01, 0.99, True),
                 JaxAdaptive(0.01, 0.99, True)),
    "adaptive_noclip": (AdaptiveNormalizer(0.05, 0.95, False),
                        JaxAdaptive(0.05, 0.95, False)),
}


@pytest.mark.parametrize("norm", list(NORMS))
@pytest.mark.parametrize("interp", ["LINEAR", "NN"])
@pytest.mark.parametrize("geom,fill", [("axis", 0.0), ("axis", -1000.0),
                                       ("rotated", 0.0), ("rotated", -1000.0)])
def test_prep_modality_matches_jax(geom, fill, interp, norm):
    data = source()
    pf, jf = frames(geom)
    size_xyz = np.array(data.shape[::-1])
    _, valid = tg.resampled_frame(pf, size_xyz, (1.0, 1.0, 1.0), 1)
    if geom == "axis":  # the iso grid keeps the source direction
        dst_f, dst_size = tg.resampled_frame(pf, size_xyz, (1.0, 1.0, 1.0), 16)
        jdst_f, jdst_size = jg.resampled_frame(jf, size_xyz, (1.0, 1.0, 1.0), 16)
    else:  # an axis-aligned grid over a rotated source: the gather path
        center = pf.voxel_center_world(size_xyz)
        dst_size = jdst_size = np.array([24, 20, 16])
        dst_f = tg.frame_for_crop(tg.Frame.identity(), center, dst_size, (1, 1, 1))
        jdst_f = jg.frame_for_crop(jg.Frame.identity(), center, dst_size, (1, 1, 1))
    valid_zyx = tuple(int(v) for v in valid[::-1])
    pn, jn = NORMS[norm]
    got = prep_modality(Volume(data, pf), dst_f, dst_size, interp, pn,
                        valid_zyx, fill, CPU).numpy()
    kind, coeffs, out_shape = jr.resample_plan(jf, jdst_f, jdst_size)
    assert (kind == "sep") == (geom == "axis")
    spec = tuple(sorted(jn.to_dict().items())) if jn is not None else None
    ref = np.asarray(_prep_modality(
        jnp.asarray(data), jnp.asarray(coeffs), jnp.asarray(0.0, jnp.float32),
        kind=kind, out_shape=out_shape, interp=interp, fill=fill,
        norm_spec=spec,
        valid_zyx=valid_zyx if isinstance(jn, JaxAdaptive) else None))
    assert got.shape == ref.shape == tuple(int(v) for v in dst_size[::-1])
    tol = 1e-5 if norm != "none" else 1e-5 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=tol)


@pytest.mark.parametrize("geom", ["axis", "rotated"])
def test_nn_label_resample_is_exact(geom):
    rng = np.random.default_rng(4)
    labels = rng.integers(0, 3, size=(14, 18, 20)).astype(np.int32)
    pf, jf = frames(geom)
    size_xyz = np.array(labels.shape[::-1])
    if geom == "axis":
        iso_f, iso_size = tg.resampled_frame(pf, size_xyz, (1.0, 1.0, 1.0), 16)
        jiso_f, _ = jg.resampled_frame(jf, size_xyz, (1.0, 1.0, 1.0), 16)
    else:
        center = pf.voxel_center_world(size_xyz)
        iso_size = np.array([24, 20, 16])
        iso_f = tg.frame_for_crop(tg.Frame.identity(), center, iso_size, (1, 1, 1))
        jiso_f = jg.frame_for_crop(jg.Frame.identity(), center, iso_size, (1, 1, 1))
    # back from the iso grid to the native one, as the mask takes
    iso = rng.integers(0, 3, size=tuple(int(v) for v in iso_size[::-1])).astype(np.int32)
    kind, coeffs, shape = tr.resample_plan(iso_f, pf, size_xyz)
    got = tr.resample_exec(torch.from_numpy(iso), kind, coeffs, shape, interp="NN")
    jkind, jcoeffs, jshape = jr.resample_plan(jiso_f, jf, size_xyz)
    ref = np.asarray(jr.resample_exec(jnp.asarray(iso), jkind, jcoeffs, jshape,
                                      interp="NN"))
    assert (kind == "sep") == (geom == "axis") and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("pct", [0.0, 0.1, 1.0, 37.5, 50.0, 99.9, 100.0])
def test_percentile_matches_jnp(pct):
    x = np.random.default_rng(5).normal(size=(13, 17, 19)).astype(np.float32) * 50
    got = float(percentile(torch.from_numpy(x), pct))
    ref = float(jnp.percentile(jnp.asarray(x), pct))
    assert abs(got - ref) <= 1e-6 * max(1.0, abs(ref))


def test_percentile_sequence_takes_one_sort():
    """A sequence of percentages gives what each gives alone, as the
    adaptive normalizer asks for both ends of its window at once."""
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(9, 11, 13)).astype(np.float32))
    both = percentile(x, (0.1, 99.9))
    assert both.shape == (2,)
    assert torch.equal(both, torch.stack([percentile(x, 0.1), percentile(x, 99.9)]))


def test_normalizer_dicts_round_trip():
    for n in (FixedNormalizer(1.0, 2.0, False), AdaptiveNormalizer(0.02, 0.98)):
        assert normalizer_from_dict(n.to_dict()).to_dict() == n.to_dict()
    with pytest.raises(ValueError):
        normalizer_from_dict({"type": 7})
