"""Coarse-to-fine in the port against the JAX package's
``core/coarse_to_fine.py`` on the CPU, float32, the same seeded weights:
the ROI reductions and the centre-anchored fine grid, the two-pass
pipeline (masks by tests/test_torch_port_seg_infer.py's rule, probability
maps within 2e-3), an empty ROI, a fine ensemble, and the CLI's flags and
SystemExit rules against the JAX CLI's.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import segmentation3d_tpu.cli.seg_infer as jax_cli
import segmentation3d_tpu.core.coarse_to_fine as jc
import segmentation3d_tpu_torch.cli.seg_infer as port_cli
from phantoms import make_sphere_case
from segmentation3d_tpu.io import Volume as JaxVolume
from segmentation3d_tpu.io import read_image as jax_read
from segmentation3d_tpu.ops.geometry import Frame as JaxFrame
from segmentation3d_tpu.utils import model_io as jax_io
from segmentation3d_tpu.utils.normalizer import AdaptiveNormalizer
from segmentation3d_tpu_torch.core import coarse_to_fine as tc
from segmentation3d_tpu_torch.core.seg_infer import prepare_cases
from segmentation3d_tpu_torch.io import Volume
from segmentation3d_tpu_torch.ops.geometry import Frame
from test_torch_port_checkpoint import KW, seeded_variables
from test_torch_port_pipeline import assert_same_mask, save_model

PERM = np.eye(3)[[1, 0, 2]]  # x/y swap
DIRECTIONS = {"identity": np.eye(3), "flip_xy": np.diag([-1.0, -1.0, 1.0]),
              "permuted": PERM @ np.diag([-1.0, 1.0, -1.0])}


def test_roi_bounds_match_jax():
    rng = np.random.default_rng(0)
    mask = np.zeros((20, 24, 28), np.uint8)
    mask[3:9, 5:12, 7:20] = rng.random((6, 7, 13)) > 0.5
    mask[4, 6, 8] = 2
    for m in (mask, np.zeros((4, 5, 6), np.uint8), mask[::-1, :, ::-1].copy()):
        got = tc._roi_bounds(torch.from_numpy(m)).numpy()
        ref = np.asarray(jc._roi_bounds(jnp.asarray(m)))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("direction", list(DIRECTIONS))
def test_roi_from_mask_matches_jax(direction):
    mask = np.zeros((20, 20, 20), np.uint8)
    mask[5:10, 6:11, 7:12] = 1
    args = (np.array([4.0, -3.0, 2.0]), np.array([2.0, 1.5, 1.0]),
            DIRECTIONS[direction])
    got = tc.roi_from_mask(mask, Frame(*args), margin_mm=4.0)
    ref = jc.roi_from_mask(mask, JaxFrame(*args), margin_mm=4.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    assert tc.roi_from_mask(np.zeros((4, 4, 4)), Frame(*args)) is None


@pytest.mark.parametrize("direction", list(DIRECTIONS))
def test_fine_grid_matches_jax(direction):
    args = (np.array([5.0, -3.0, 2.0]), np.array([0.8, 1.0, 1.2]),
            DIRECTIONS[direction])
    data = np.zeros((40, 36, 44), np.float32)
    native, jnative = Volume(data, Frame(*args)), JaxVolume(data, JaxFrame(*args))
    corners = np.asarray([native.frame.index_to_world([i, j, k]) for i in (0, 43)
                          for j in (0, 35) for k in (0, 39)])
    lo = corners.min(axis=0) + 6.0
    hi = lo + np.array([10.0, 14.0, 60.0])  # overruns the volume in one axis
    for bucket in (1, 32):
        f, size, raw = tc._fine_grid_for_roi(lo, hi, native, (1.0, 1.0, 1.0), 16,
                                             bucket=bucket)
        jf, jsize, jraw = jc._fine_grid_for_roi(lo, hi, jnative, (1.0, 1.0, 1.0),
                                                16, bucket=bucket)
        np.testing.assert_array_equal(size, jsize)
        np.testing.assert_array_equal(raw, jraw)
        for a, b in ((f.origin, jf.origin), (f.spacing, jf.spacing),
                     (f.direction, jf.direction)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def test_post_prob_roi_matches_jax():
    prob = np.random.default_rng(2).dirichlet((1, 1), size=(6, 7, 8)).astype(np.float32)
    src = Frame(np.array([3.0, 2.0, 1.0]), np.ones(3), np.eye(3))
    dst = Frame.identity()
    from segmentation3d_tpu.ops.resample import resample_plan as jplan
    from segmentation3d_tpu_torch.ops.resample import resample_plan
    kind, coeffs, shape = resample_plan(src, dst, np.array([12, 11, 10]))
    jkind, jcoeffs, jshape = jplan(JaxFrame(src.origin, src.spacing, src.direction),
                                   JaxFrame.identity(), np.array([12, 11, 10]))
    got = tc._post_prob_roi(torch.from_numpy(prob), kind, coeffs, shape).numpy()
    ref = np.asarray(jc._post_prob_roi(jnp.asarray(prob), jnp.asarray(jcoeffs),
                                       kind=jkind, out_shape=jshape))
    assert got.dtype == np.float16
    np.testing.assert_array_equal(got, ref)
    assert got[0, 0, 0, 0] == 1.0 and got[0, 0, 0, 1] == 0.0  # outside: [1, 0]


@pytest.fixture(scope="module")
def c2f(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("c2f"))
    imgs, _ = make_sphere_case(d, "case", shape_zyx=(30, 34, 28),
                               spacing=(1.1, 0.9, 1.3))
    coarse = save_model(os.path.join(d, "coarse"), seed=4, spacing=(2.0, 2.0, 2.0))
    fine = save_model(os.path.join(d, "fine"), seed=4)
    return d, imgs[0], coarse, fine


C2F = dict(partition_size=(16, 16, 16), partition_stride=(8, 8, 8), margin_mm=4.0,
           save_prob=True)


def test_pipeline_matches_jax(c2f):
    d, img, coarse, fine = c2f
    jc.segmentation_coarse_to_fine(img, coarse, fine, os.path.join(d, "jax"),
                                   save_image=True, **C2F)
    res = tc.segmentation_coarse_to_fine(img, coarse, fine, os.path.join(d, "port"),
                                         device="cpu", save_image=True, **C2F)
    assert [r[0] for r in res] == ["case_mod0"]
    assert set(res[0][2]) == {"read", "prep", "forward", "back", "write"}
    assert_same_mask(os.path.join(d, "port"), os.path.join(d, "jax"))
    np.testing.assert_array_equal(
        jax_read(os.path.join(d, "port", "case_mod0", "org.mha")).data,
        jax_read(img).data)
    p0, p1 = (jax_read(os.path.join(d, "port", "case_mod0", f"prob_{c}.mha")).data
              for c in (0, 1))
    np.testing.assert_allclose(p0 + p1, 1.0, atol=2e-3)  # a distribution everywhere


def test_prepared_input_and_post_processing(c2f):
    d, img, coarse, fine = c2f
    kw = dict(C2F, post_processing={"type": "largest_cc"})
    jc.segmentation_coarse_to_fine(img, coarse, fine, os.path.join(d, "jax_cc"), **kw)
    tc.segmentation_coarse_to_fine(img, coarse, fine, os.path.join(d, "port_cc"),
                                   device="cpu",
                                   prepared=prepare_cases(img, device="cpu"), **kw)
    a, b = (jax_read(os.path.join(d, r, "case_mod0", "seg.mha")).data
            for r in ("jax_cc", "port_cc"))
    np.testing.assert_array_equal(a, b)


def test_fine_ensemble(c2f, tmp_path):
    d, img, coarse, fine = c2f
    other = save_model(tmp_path / "fine2", seed=13)
    jc.segmentation_coarse_to_fine(img, coarse, [fine, other],
                                   os.path.join(d, "jax_ens"), **C2F)
    tc.segmentation_coarse_to_fine(img, coarse, [fine, other],
                                   os.path.join(d, "port_ens"), device="cpu", **C2F)
    assert_same_mask(os.path.join(d, "port_ens"), os.path.join(d, "jax_ens"))
    kw = dict(C2F, save_prob=False)
    # the same fine model twice is the model alone, voxel for voxel
    tc.segmentation_coarse_to_fine(img, coarse, fine, os.path.join(d, "one"),
                                   device="cpu", **kw)
    tc.segmentation_coarse_to_fine(img, coarse, [fine, fine], os.path.join(d, "two"),
                                   device="cpu", **kw)
    a, b = (jax_read(os.path.join(d, r, "case_mod0", "seg.mha")).data
            for r in ("one", "two"))
    np.testing.assert_array_equal(a, b)


def test_fine_pass_shards(c2f):
    """``num_devices`` splits the fine pass's patch batches over the shards
    (the coarse pass stays on the first device): JAX's run on a 3-device
    mesh and the port's on 3 CPU shards agree by the pipeline's rule, and
    the port's sharded mask is its unsharded one."""
    d, img, coarse, fine = c2f
    kw = dict(C2F, save_prob=False)
    jc.segmentation_coarse_to_fine(img, coarse, fine, os.path.join(d, "jax_n3"),
                                   num_devices=3, **kw)
    tc.segmentation_coarse_to_fine(img, coarse, fine, os.path.join(d, "port_n3"),
                                   device="cpu", num_devices=3, **kw)
    sess = next(s for s in tc._C2F_SESSIONS.values()
                if s["fine_inferers"][0].devices is not None)
    assert sess["fine_inferers"][0].devices == [torch.device("cpu")] * 3
    assert sess["coarse_inferers"] == {} or all(
        i.devices is None for i in sess["coarse_inferers"].values())
    tc.segmentation_coarse_to_fine(img, coarse, fine, os.path.join(d, "port_n1"),
                                   device="cpu", **kw)
    assert_same_mask(os.path.join(d, "port_n3"), os.path.join(d, "jax_n3"))
    a, b = (jax_read(os.path.join(d, r, "case_mod0", "seg.mha")).data
            for r in ("port_n3", "port_n1"))
    np.testing.assert_array_equal(a, b)


def test_empty_roi_gives_background(c2f, tmp_path):
    """A coarse model that finds no foreground: a background mask and
    probabilities [1, 0] everywhere, in both packages."""
    d, img, _, fine = c2f
    v, _ = seeded_variables(seed=4)
    v["params"]["out_block"]["proj"]["bias"] = np.array([50.0, -50.0], np.float32)
    coarse = str(tmp_path / "bg")
    jax_io.save_checkpoint(coarse, 1, 0, v, "vnet", 4, 1, 2, [2.0, 2.0, 2.0],
                           "LINEAR", [AdaptiveNormalizer()],
                           extra={"net_kwargs": dict(KW)})
    for pkg, run in (("jax", jc.segmentation_coarse_to_fine),
                     ("port", lambda *a, **k: tc.segmentation_coarse_to_fine(
                         *a, device="cpu", **k))):
        run(img, coarse, fine, str(tmp_path / pkg), **C2F)
        out = str(tmp_path / pkg / "case_mod0")
        assert jax_read(os.path.join(out, "seg.mha")).data.max() == 0
        np.testing.assert_array_equal(jax_read(os.path.join(out, "prob_0.mha")).data, 1.0)
        np.testing.assert_array_equal(jax_read(os.path.join(out, "prob_1.mha")).data, 0.0)


def test_patch_rounds_up_to_the_fine_stride(c2f):
    d, img, coarse, fine = c2f
    sess = tc._build_c2f_session(coarse, [fine], torch.float32, (18, 18, 18),
                                 (18, 18, 18), 2, torch.device("cpu"))
    assert sess["patch"] == sess["stride"] == (20, 20, 20)  # max_stride 4
    with pytest.raises(ValueError, match="calib_image"):
        tc.segmentation_coarse_to_fine(img, coarse, fine, os.path.join(d, "cal"),
                                       device="cpu", calib_image=img)


# ---- the CLI: flags and SystemExit rules against the JAX CLI's ------------

BASE = ["-i", "in.nii.gz", "-m", "coarse", "-o", "out"]
REFUSED = [
    ["--fine_checkpoint", "best"],
    ["--coarse_checkpoint", "3"],
    ["--fine_model", "f", "--checkpoint", "best"],
    ["-m", "coarse2", "--fine_model", "f"],
    ["--fine_model", "f", "--spatial_shard"],
]


@pytest.mark.parametrize("extra", REFUSED, ids=lambda a: "_".join(a))
def test_cli_rules_match_jax(extra):
    with pytest.raises(SystemExit) as ref:
        jax_cli.main(BASE + extra)
    with pytest.raises(SystemExit) as got:
        port_cli.main(BASE + extra + ["-g", "-1"])
    assert isinstance(ref.value.code, str)
    assert got.value.code == ref.value.code


ACCEPTED = [
    ["--fine_model", "f"],
    ["--fine_model", "f", "--fine_model", "g", "--roi_margin", "8",
     "--coarse_checkpoint", "2", "--fine_checkpoint", "best", "--tta", "x",
     "--partition_size", "32", "32", "32", "--partition_stride", "16", "16", "16",
     "--save_prob", "--save_image", "--post", "largest_cc", "--batch_size", "2",
     "--blend", "constant", "--bf16", "--num_devices", "2"],
    ["--fine_model", "f", "--int8", "--int8_calib", "a.nii.gz", "--act_clip", "5"],
]


@pytest.mark.parametrize("extra", ACCEPTED, ids=lambda a: "_".join(a)[:40])
def test_cli_flags_match_jax(extra, monkeypatch):
    """What the CLI hands segmentation_coarse_to_fine: every option as JAX's
    CLI hands it (the dtype as the port's type, ``num_devices`` for the
    fine pass included), nothing refused."""
    calls = {}

    def record(tag):
        def call(**kw):
            calls[tag] = kw
        return call
    monkeypatch.setattr(jc, "segmentation_coarse_to_fine", record("jax"))
    monkeypatch.setattr(port_cli, "segmentation_coarse_to_fine", record("port"))
    jax_cli.main(BASE + extra)
    port_cli.main(BASE + extra + ["-g", "-1"])
    ref, got = calls["jax"], calls["port"]
    assert got.pop("gpu_id") == -1
    jdt, tdt = ref.pop("dtype"), got.pop("dtype")
    assert (jdt == jnp.bfloat16) == (tdt == torch.bfloat16)
    assert got == ref
