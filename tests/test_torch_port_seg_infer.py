"""The slice end to end: a JAX-saved base-4 checkpoint and a phantom through
JAX's segmentation() and the port's seg_infer CLI on the CPU, in float32.

The masks must be identical, or agree on >= 99.9% of voxels with every
differing voxel an argmax near-tie: |p0 - p1| < 1e-4 in JAX's probability
maps, plus their float16 storage step (2^-11 near 0.5).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phantoms import make_sphere_case
from segmentation3d_tpu.core.seg_infer import segmentation as jax_segmentation
from segmentation3d_tpu.io import read_image as jax_read
from segmentation3d_tpu.utils import model_io as jax_io
from segmentation3d_tpu.utils.normalizer import AdaptiveNormalizer
from segmentation3d_tpu_torch.cli.seg_infer import main as seg_infer
from segmentation3d_tpu_torch.core.seg_infer import segmentation
from segmentation3d_tpu_torch.ops import thin_conv, window_i8
from test_torch_port_checkpoint import KW, seeded_variables

PARTITIONS = {
    "DISABLE": {},
    "SIZE": {"partition_size": [16, 16, 16], "partition_stride": [8, 8, 8]},
    "SLAB": {"partition_size": [32, 32, 16], "partition_stride": [8, 8, 8]},
    "NUM": {"partition_size": [2, 1, 2]},
}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("e2e"))
    imgs, _ = make_sphere_case(d, "case", shape_zyx=(30, 34, 28),
                               spacing=(1.1, 0.9, 1.3))
    v, _ = seeded_variables(seed=4)
    model_dir = os.path.join(d, "model")
    jax_io.save_checkpoint(model_dir, 1, 0, v, "vnet", 4, 1, 2, [1.0, 1.0, 1.0],
                           "LINEAR", [AdaptiveNormalizer()],
                           extra={"net_kwargs": dict(KW)})
    return d, imgs[0], model_dir


@pytest.mark.parametrize("partition", list(PARTITIONS))
def test_cli_matches_jax_segmentation(case, partition):
    d, img, model_dir = case
    opts = PARTITIONS[partition]
    jax_segmentation(img, model_dir, os.path.join(d, "jax_" + partition),
                     partition_type=partition, save_prob=True, **opts)
    argv = ["-i", img, "-m", model_dir, "-o", os.path.join(d, "port_" + partition),
            "-g", "-1", "--save_prob", "--save_image",
            "--partition_type", partition]
    for k, v in opts.items():
        argv += [f"--{k}"] + [str(t) for t in v]
    res = seg_infer(argv)
    assert [r[0] for r in res] == ["case_mod0"]
    assert set(res[0][2]) == {"read", "prep", "forward", "back", "write"}

    def out(root, name):
        return jax_read(os.path.join(d, root, "case_mod0", name))
    ref, got = out("jax_" + partition, "seg.mha"), out("port_" + partition, "seg.mha")
    assert got.data.shape == ref.data.shape == (30, 34, 28)
    assert got.data.dtype == np.uint8
    assert got.frame.to_dict() == ref.frame.to_dict()
    assert 0.05 < np.mean(ref.data == 1) < 0.95  # both labels present
    differ = got.data != ref.data
    assert differ.mean() <= 1e-3
    p0, p1 = (out("jax_" + partition, f"prob_{c}.mha").data for c in (0, 1))
    assert np.all(np.abs(p0 - p1)[differ] < 1e-4 + 2.0 ** -11)
    for c in (0, 1):
        np.testing.assert_allclose(out("port_" + partition, f"prob_{c}.mha").data,
                                   out("jax_" + partition, f"prob_{c}.mha").data,
                                   atol=2e-3)
    np.testing.assert_array_equal(out("port_" + partition, "org.mha").data,
                                  jax_read(img).data)


def test_post_processing_keeps_largest_component(case):
    d, img, model_dir = case
    base = ["-i", img, "-m", model_dir, "-g", "-1"]
    seg_infer(base + ["-o", os.path.join(d, "plain")])
    seg_infer(base + ["-o", os.path.join(d, "post"), "--post", "largest_cc"])
    plain = jax_read(os.path.join(d, "plain", "case_mod0", "seg.mha")).data
    post = jax_read(os.path.join(d, "post", "case_mod0", "seg.mha")).data
    assert np.all(post <= plain)  # only removes foreground


def test_checkpoint_selector(case):
    d, img, model_dir = case
    with pytest.raises(FileNotFoundError):
        segmentation(img, model_dir, os.path.join(d, "sel"), checkpoint=7,
                     device="cpu")


def test_segmentation_refuses_silent_cpu(case):
    """Without a CUDA device the entry point raises unless the CPU is asked
    for: there is no silent CPU path."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    d, img, model_dir = case
    with pytest.raises(RuntimeError, match="CUDA"):
        segmentation(img, model_dir, os.path.join(d, "nocuda"))
    with pytest.raises(RuntimeError, match="CUDA"):
        seg_infer(["-i", img, "-m", model_dir, "-o", os.path.join(d, "nocuda")])
    with pytest.raises(RuntimeError, match="CUDA"):
        seg_infer(["-i", img, "-m", model_dir, "-o", os.path.join(d, "nocuda"),
                   "--int8"])


@pytest.mark.parametrize("extra", [["--num_devices", "2"], ["--spatial_shard"]])
def test_cli_refuses_unported_options(extra, capsys):
    with pytest.raises(SystemExit) as e:
        seg_infer(["-i", "in.nii.gz", "-m", "model", "-o", "out", "-g", "-1"]
                  + extra)
    assert e.value.code == 2
    assert "not ported" in capsys.readouterr().err


def test_cli_bf16_on_cpu(case):
    """--bf16 on the CPU runs the nn.Module under bf16 autocast (the folded
    kernel forward is the CUDA rule); its mask agrees with float32 on
    >= 98% of voxels (tests/test_pallas_conv.py's bf16 bar)."""
    d, img, model_dir = case
    base = ["-i", img, "-m", model_dir, "-g", "-1"]
    seg_infer(base + ["-o", os.path.join(d, "f32")])
    seg_infer(base + ["-o", os.path.join(d, "bf16"), "--bf16"])
    a = jax_read(os.path.join(d, "f32", "case_mod0", "seg.mha")).data
    b = jax_read(os.path.join(d, "bf16", "case_mod0", "seg.mha")).data
    assert np.mean(a == b) >= 0.98


@pytest.mark.parametrize("calibrated", [False, True])
def test_cli_int8_matches_jax_segmentation(case, calibrated):
    """``seg_infer --int8 -g -1`` (the int8 forward through the plain
    versions: no kernel launch) vs JAX's segmentation(quant="int8",
    fused=True, dtype=bf16), whose packed route needs the patch width to
    be a multiple of 32 for base 4: DISABLE gives one 64^3 bucket. The two
    differ only in the stem's rounding (test_torch_port_int8_forward.py);
    the masks must agree on >= 98% of voxels (tests/test_quant.py's bar;
    measured 0.9828 uncalibrated, 0.9837 calibrated on the phantom image
    itself, with max |dprob| 0.073 and 0.051: the int8 noise level of this
    small seeded net, whose JAX int8 mask agrees with its float32 mask on
    0.9826 and 0.9834 of voxels)."""
    d, img, model_dir = case
    tag = "calib" if calibrated else "int8"
    jax_segmentation(img, model_dir, os.path.join(d, "jax_" + tag),
                     quant="int8", fused=True, dtype=jnp.bfloat16,
                     calib_image=img if calibrated else None, save_prob=True)
    launches = (thin_conv.thin_conv3d.launches, window_i8.window_conv_i8.launches)
    argv = ["-i", img, "-m", model_dir, "-o", os.path.join(d, "port_" + tag),
            "-g", "-1", "--int8", "--save_prob"]
    res = seg_infer(argv + (["--int8_calib", img] if calibrated else []))
    assert [r[0] for r in res] == ["case_mod0"]
    assert (thin_conv.thin_conv3d.launches,
            window_i8.window_conv_i8.launches) == launches

    def out(root, name):
        return jax_read(os.path.join(d, root, "case_mod0", name)).data
    ref, got = out("jax_" + tag, "seg.mha"), out("port_" + tag, "seg.mha")
    assert got.shape == ref.shape == (30, 34, 28)
    assert 0.05 < np.mean(ref == 1) < 0.95  # both labels present
    assert np.mean(got == ref) >= 0.98
    for c in (0, 1):
        p = out("port_" + tag, f"prob_{c}.mha")
        assert np.all(np.isfinite(p)) and p.min() >= 0 and p.max() <= 1


def test_cli_refuses_int8_calib_without_int8(tmp_path):
    """The JAX package's error: a calibration image needs --int8."""
    with pytest.raises(ValueError, match="calib_image only applies with quant"):
        seg_infer(["-i", "in.nii.gz", "-m", "model", "-o", str(tmp_path),
                   "-g", "-1", "--int8_calib", "x.nii.gz"])


def test_cli_accepts_act_clip_alone(case):
    """--act_clip without --int8 is accepted and changes nothing, as in the
    JAX CLI."""
    d, img, model_dir = case
    base = ["-i", img, "-m", model_dir, "-g", "-1"]
    seg_infer(base + ["-o", os.path.join(d, "noclip")])
    seg_infer(base + ["-o", os.path.join(d, "clip"), "--act_clip", "4"])
    a = jax_read(os.path.join(d, "noclip", "case_mod0", "seg.mha")).data
    b = jax_read(os.path.join(d, "clip", "case_mod0", "seg.mha")).data
    np.testing.assert_array_equal(a, b)


def test_unknown_quant_raises(case):
    d, img, model_dir = case
    with pytest.raises(ValueError, match="quant"):
        segmentation(img, model_dir, os.path.join(d, "int4"), quant="int4",
                     device="cpu")
