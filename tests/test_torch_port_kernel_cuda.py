"""The hand-written kernels (thin_conv3d, window_conv_i8) against their
plain PyTorch versions, on a CUDA device. Imports no JAX, so it runs where
only PyTorch is installed:

    PYTHONPATH=. python -m pytest --noconftest -m cuda tests/test_torch_port_kernel_cuda.py

Tolerance 0.05 x max|ref| (tests/test_pallas_conv.py's bar); both sides
round their operands to bf16 and accumulate in float32, so the measured
error is one bf16 step of the output. An int8 output must match in more
than 99% of voxels and elsewhere differ by one step: only a sum that the
two accumulation orders put on opposite sides of a rounding midpoint may
differ, so a requant that truncated or rounded half away from zero fails.

window_conv_i8 sums int8 products in int32, exactly, and runs the plain
version's float32 epilogue op for op: its int8 outputs must be exactly
equal, its bf16 / f32 outputs too (one bf16 step is allowed).

The pipelined case loop on the card must give every case the mask that the
same case gives alone.
"""
import functools
import os
import sys

import numpy as np
import pytest
import torch

from segmentation3d_tpu_torch.models.fused_vnet import build_fused_forward
from segmentation3d_tpu_torch.models.quant_vnet import build_int8_forward
from segmentation3d_tpu_torch.models.vnet import SegmentationNet
from segmentation3d_tpu_torch.ops import conv_plan
from segmentation3d_tpu_torch.ops import thin_conv as tc
from segmentation3d_tpu_torch.ops import window_i8 as wi

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (imports only the standard library at top level)

_TDT = {"bf16": torch.bfloat16, "f32": torch.float32, "int8": torch.int8}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(cin, cout, seed, shape, device):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape + (cin,)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, cin, cout)) * (2.0 / (27 * cin)) ** 0.5
         ).astype(np.float32)
    b = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    return (torch.from_numpy(a).to(device) for a in (x, w, b))


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,residual,out", [
    (1, 16, "none", "bf16"), (4, 16, "none", "f32"), (32, 2, "none", "f32"),
    (32, 32, "relu", "bf16"), (64, 64, "prelu", "f32"), (256, 256, "none", "int8"),
    (3, 5, "none", "f32"), (24, 8, "none", "bf16"),
])
def test_kernel_matches_plain(cuda_device, cin, cout, residual, out):
    x, w, b = _inputs(cin, cout, cin + cout, (2, 6, 10, 12), cuda_device)
    q = 20.0 if out == "int8" else None
    kw = dict(act="prelu", alpha=0.1, out_dtype=_TDT[out], residual=residual,
              res_alpha=0.2, quant_inv_sa=q)
    before = tc.thin_conv3d.launches
    got = tc.thin_conv3d(x, w, b, **kw)
    ref = tc.thin_conv3d_reference(x, w, b, **kw)
    torch.cuda.synchronize()
    assert tc.thin_conv3d.launches == before + 1
    assert got.dtype == _TDT[out] and got.shape == ref.shape
    err = (got.float() - ref.float()).abs().max().item()
    if out == "int8":
        assert err <= 1
        assert (got == ref).float().mean().item() > 0.99
    else:
        assert err <= 0.05 * ref.float().abs().max().item()


# the coarse-to-fine coarse pass: one whole 96^3 grid at batch 1, every
# site of the forward; and a flipped batch as test-time augmentation feeds
COARSE_SITES = [(s, ci, co, res) for _, s, ci, co, res, _ in chip_smoke.site_list()]


@pytest.mark.cuda
@pytest.mark.parametrize("size,cin,cout,tail", COARSE_SITES)
def test_kernel_matches_plain_at_coarse_sites(cuda_device, size, cin, cout, tail):
    x, w, b = _inputs(cin, cout, size + cout, (1, size, size, size), cuda_device)
    kw = dict(act="relu", residual="relu" if tail else "none")
    for xi in (x, torch.flip(x, (1, 3))):
        got = tc.thin_conv3d(xi, w, b, **kw)
        ref = tc.thin_conv3d_reference(xi, w, b, **kw)
        torch.cuda.synchronize()
        assert (got.float() - ref.float()).abs().max().item() <= \
            0.05 * ref.float().abs().max().item()


# wgmma path: several K slices, N split across blocks, ragged boxes in x,
# y and z (W = 7 or 13 is not a multiple of the 8-voxel box)
WIDE_RAGGED = [
    (96, 96, (2, 6, 10, 12)), (64, 128, (2, 6, 10, 12)),
    (32, 2, (2, 5, 9, 7)), (32, 2, (1, 11, 6, 13)), (32, 32, (1, 9, 13, 7)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,shape", WIDE_RAGGED)
def test_kernel_wide_ragged_matches_plain(cuda_device, cin, cout, shape):
    x, w, b = _inputs(cin, cout, cin + 3 * cout, shape, cuda_device)
    for out in ("bf16", "int8"):
        q = 20.0 if out == "int8" else None
        kw = dict(act="relu", out_dtype=_TDT[out], quant_inv_sa=q,
                  residual="relu" if cin == cout else "none")
        assert tc.kernel_path(cin, cout) == "tensor_cores"
        got = tc.thin_conv3d(x, w, b, **kw)
        ref = tc.thin_conv3d_reference(x, w, b, **kw)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        if out == "int8":
            assert err <= 1
            assert (got == ref).float().mean().item() > 0.99
        else:
            assert err <= 0.05 * ref.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("stages", [1, 2])
def test_ring_depths_match_plain(cuda_device, monkeypatch, stages):
    """A ring of 1 or 2 stages over several K slices (bf16 64 -> 64: 8
    slices; int8 128 -> 64: 4): the slot is handed back to the producer
    only once its slice's wgmma are done."""
    plan = functools.partial(conv_plan.plan_conv, max_stages=stages)
    monkeypatch.setattr(tc, "plan_conv", plan)
    monkeypatch.setattr(wi, "plan_conv", plan)
    x, w, b = _inputs(64, 64, 5, (2, 6, 10, 12), cuda_device)
    got = tc.thin_conv3d(x, w, b, act="relu")
    ref = tc.thin_conv3d_reference(x, w, b, act="relu")
    xi, wq, s, bi, _ = _i8_inputs(128, 64, 6, (2, 6, 10, 12), cuda_device, False)
    got_i8 = wi.window_conv_i8(xi, wq, s, bi, "relu", inv_out=127.0 / 6.0)
    ref_i8 = wi.window_conv_i8_reference(xi, wq, s, bi, "relu", inv_out=127.0 / 6.0)
    torch.cuda.synchronize()
    assert (got.float() - ref.float()).abs().max().item() <= \
        0.05 * ref.float().abs().max().item()
    assert torch.equal(got_i8, ref_i8)


@pytest.mark.cuda
def test_folded_forward_on_card_matches_cpu(cuda_device):
    """The whole folded forward on the card (8 kernel launches for this
    net) against the same forward on the CPU (plain versions)."""
    net = SegmentationNet(1, 2, base_channels=4, down_convs=(1, 2),
                          up_convs=(2, 1)).eval()
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 16, 16, 16, 1)).astype(np.float32))
    cpu = build_fused_forward(net, torch.bfloat16)(x)
    before = tc.thin_conv3d.launches
    gpu = build_fused_forward(net.to(cuda_device), torch.bfloat16)(x.to(cuda_device))
    torch.cuda.synchronize()
    assert tc.thin_conv3d.launches == before + 8
    agree = (gpu.argmax(-1).cpu() == cpu.argmax(-1)).float().mean().item()
    assert agree > 0.98
    assert (gpu.cpu() - cpu).abs().max().item() < 0.1


def test_cpu_tensor_never_launches():
    """Without a card the wrapper runs the plain version for CPU tensors
    and counts no launch."""
    x, w, b = _inputs(4, 16, 1, (1, 4, 6, 16), "cpu")
    before = tc.thin_conv3d.launches
    got = tc.thin_conv3d(x, w, b, act="relu")
    assert torch.equal(got, tc.thin_conv3d_reference(x, w, b, act="relu"))
    assert tc.thin_conv3d.launches == before


def _i8_inputs(cin, cout, seed, shape, device, tail):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, shape + (cin,)).astype(np.int8)
    w = rng.integers(-127, 128, (3, 3, 3, cin, cout)).astype(np.int8)
    s = (rng.uniform(0.5, 1.5, cout) / (127.0 * 127.0 * 3 * cin ** 0.5)).astype(np.float32)
    b = rng.normal(0, 0.5, cout).astype(np.float32)
    ident = rng.integers(-127, 128, shape + (cout,)).astype(np.int8) if tail else None
    return [torch.from_numpy(a).to(device) if a is not None else None
            for a in (x, w, s, b, ident)]


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,act,tail,out", [
    (32, 32, "relu", True, "int8"), (64, 64, "prelu", False, "int8"),
    (128, 64, "relu", False, "int8"), (256, 256, "relu", False, "int8"),
    (32, 2, "relu", False, "bf16"), (32, 32, "prelu", True, "f32"),
    (8, 8, "relu", True, "int8"), (4, 8, "prelu", False, "int8"),
    (3, 5, "none", False, "int8"), (16, 16, "relu", False, "bf16"),
])
def test_window_conv_i8_matches_plain(cuda_device, cin, cout, act, tail, out):
    x, w, s, b, ident = _i8_inputs(cin, cout, cin * 7 + cout, (2, 6, 10, 12),
                                   cuda_device, tail)
    kw = dict(out=out, inv_out=127.0 / 6.0 if out == "int8" else None,
              identity=ident, s_id=5.0 / 127.0 if tail else None,
              res_act=act if tail and act != "none" else "none", res_alpha=0.3)
    before = wi.window_conv_i8.launches
    got = wi.window_conv_i8(x, w, s, b, act, 0.2, **kw)
    ref = wi.window_conv_i8_reference(x, w, s, b, act, 0.2, **kw)
    torch.cuda.synchronize()
    assert wi.window_conv_i8.launches == before + 1
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if out == "int8":
        assert torch.equal(got, ref)
        assert 0.05 < (got != 0).float().mean().item()  # not all saturated / zero
    else:
        torch.testing.assert_close(got.float(), ref.float(), rtol=2.0 ** -8, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,shape", WIDE_RAGGED)
def test_window_conv_i8_wide_ragged_matches_plain(cuda_device, cin, cout, shape):
    tail = cin == cout
    x, w, s, b, ident = _i8_inputs(cin, cout, cin * 5 + cout, shape, cuda_device,
                                   tail)
    assert wi.kernel_path(cin, cout) == "tensor_cores"
    for out in ("int8", "bf16"):
        kw = dict(out=out, inv_out=127.0 / 6.0 if out == "int8" else None,
                  identity=ident, s_id=5.0 / 127.0 if tail else None,
                  res_act="relu" if tail else "none")
        got = wi.window_conv_i8(x, w, s, b, "relu", **kw)
        ref = wi.window_conv_i8_reference(x, w, s, b, "relu", **kw)
        torch.cuda.synchronize()
        if out == "int8":
            assert torch.equal(got, ref)
            assert 0.05 < (got != 0).float().mean().item()
        else:
            torch.testing.assert_close(got.float(), ref.float(), rtol=2.0 ** -8, atol=0)


@pytest.mark.cuda
def test_int8_forward_on_card_matches_cpu(cuda_device):
    """The whole int8 forward on the card (1 thin_conv3d + 7 window_conv_i8
    launches for this net: 1 + 2 + 2 + 1 residual convs and the head)
    against the same forward on the CPU (plain
    versions): they differ only in the stem's float32 sum order."""
    net = SegmentationNet(1, 2, base_channels=16, down_convs=(1, 2),
                          up_convs=(2, 1)).eval()
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 16, 16, 32, 1)).astype(np.float32))
    cpu = build_int8_forward(net)(x)
    before = (tc.thin_conv3d.launches, wi.window_conv_i8.launches)
    gpu = build_int8_forward(net.to(cuda_device))(x.to(cuda_device))
    torch.cuda.synchronize()
    assert (tc.thin_conv3d.launches, wi.window_conv_i8.launches) == \
        (before[0] + 1, before[1] + 7)
    agree = (gpu.argmax(-1).cpu() == cpu.argmax(-1)).float().mean().item()
    assert agree >= 0.99


def test_window_conv_i8_cpu_tensor_never_launches():
    x, w, s, b, ident = _i8_inputs(8, 8, 3, (1, 4, 6, 8), "cpu", True)
    before = wi.window_conv_i8.launches
    kw = dict(out="int8", inv_out=20.0, identity=ident, s_id=0.05,
              res_act="relu")
    got = wi.window_conv_i8(x, w, s, b, "relu", **kw)
    assert torch.equal(got, wi.window_conv_i8_reference(x, w, s, b, "relu", **kw))
    assert wi.window_conv_i8.launches == before


@pytest.mark.cuda
def test_pipeline_on_card_matches_one_case_at_a_time(cuda_device, tmp_path):
    """Three cases of different shapes through the pipelined loop (bf16,
    kernel forward) give the masks that each case gives alone."""
    from segmentation3d_tpu_torch.core.seg_infer import segmentation
    from segmentation3d_tpu_torch.io import Volume, read_image, write_image
    from segmentation3d_tpu_torch.ops.geometry import Frame
    from segmentation3d_tpu_torch.utils.model_io import save_checkpoint
    from segmentation3d_tpu_torch.utils.normalizer import AdaptiveNormalizer
    kw = dict(base_channels=16, down_convs=(1, 2), up_convs=(2, 1))
    torch.manual_seed(0)
    net = SegmentationNet(1, 2, **kw).eval()
    model = str(tmp_path / "model")
    save_checkpoint(model, 1, 0, net.state_dict(), "vnet", 4, 1, 2, [1.0] * 3,
                    "LINEAR", [AdaptiveNormalizer()], extra={"net_kwargs": kw})
    rng = np.random.default_rng(0)
    names = []
    for i, shape in enumerate([(40, 44, 36), (36, 40, 52), (44, 36, 40)]):
        z, y, x = np.mgrid[:shape[0], :shape[1], :shape[2]]
        ball = (z - shape[0] / 2) ** 2 + (y - 20) ** 2 + (x - 18) ** 2 < 150
        img = np.where(ball, 200, -100) + rng.normal(0, 20, shape)
        names.append(f"c{i}")
        write_image(Volume(img.astype(np.int16), Frame.identity((1.1, 0.9, 1.3))),
                    str(tmp_path / "in" / f"c{i}.nii.gz"))
    opts = dict(dtype=torch.bfloat16, partition_type="SIZE", batch_size=4,
                partition_size=[32, 32, 32], partition_stride=[16, 16, 16],
                save_prob=True)
    before = tc.thin_conv3d.launches
    res = segmentation(str(tmp_path / "in"), model, str(tmp_path / "all"), **opts)
    assert [r[0] for r in res] == names
    assert tc.thin_conv3d.launches > before
    for name in names:
        segmentation(str(tmp_path / "in" / f"{name}.nii.gz"), model,
                     str(tmp_path / "one"), **opts)
        for f in ("seg.mha", "prob_1.mha"):
            a, b = (read_image(str(tmp_path / r / name / f)).data
                    for r in ("all", "one"))
            np.testing.assert_array_equal(a, b)


# in-training validation runs the folded forward on one whole volume (up to
# 256^3) or on 64-plane full-XY slabs, batch 1: the largest grids and TMA
# boxes the kernel meets
VALIDATION_SITES = [((1, 240, 224, 224), 32, 32, "relu"),
                    ((1, 256, 256, 256), 32, 32, "relu"),
                    ((1, 64, 512, 512), 32, 2, "none")]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cin,cout,tail", VALIDATION_SITES)
def test_kernel_matches_plain_at_validation_sites(cuda_device, shape, cin, cout, tail):
    g = torch.Generator(device=cuda_device).manual_seed(cin + cout)
    x = torch.randn(*shape, cin, device=cuda_device, generator=g).to(torch.bfloat16)
    w = torch.randn(3, 3, 3, cin, cout, device=cuda_device, generator=g) \
        * (2.0 / (27 * cin)) ** 0.5
    b = torch.randn(cout, device=cuda_device, generator=g) * 0.1
    got = tc.thin_conv3d(x, w, b, act="relu", residual=tail)
    ref = tc.thin_conv3d_reference(x, w, b, act="relu", residual=tail)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == shape + (cout,)
    assert (got.float() - ref.float()).abs().max().item() <= \
        0.05 * ref.float().abs().max().item()


@pytest.mark.cuda
def test_dicom_series_on_card_matches_cpu(cuda_device, tmp_path):
    """``seg_infer --bf16`` on a small DICOM series: the card (the folded
    forward through thin_conv3d) gives the mask of the same forward on the
    CPU (its plain versions) on >= 99.9% of voxels, and exactly the mask
    the card gives the series' NIfTI copy (a grid exact in both formats).
    The net's head is fitted to the phantom's ball, so the mask has teeth."""
    from segmentation3d_tpu_torch.cli.seg_infer import main as seg_infer
    from segmentation3d_tpu_torch.core.seg_infer import segmentation
    from segmentation3d_tpu_torch.io import Volume, read_image, write_image
    from segmentation3d_tpu_torch.io.dicom import write_dicom_series
    from segmentation3d_tpu_torch.ops.geometry import Frame
    from segmentation3d_tpu_torch.utils.model_io import save_checkpoint
    from segmentation3d_tpu_torch.utils.normalizer import FixedNormalizer
    shape = (32, 48, 40)
    z, y, x = np.mgrid[:shape[0], :shape[1], :shape[2]]
    ball = (z - 15) ** 2 + (y - 22) ** 2 + (x - 20) ** 2 < 150
    img = (np.where(ball, 200, -100)
           + np.random.default_rng(0).normal(0, 20, shape)).astype(np.int16)
    kw = dict(base_channels=16, down_convs=(1, 2), up_convs=(2, 1))
    torch.manual_seed(0)
    norm = FixedNormalizer(40.0, 400.0, True)
    net = chip_smoke.calibrate(torch, SegmentationNet(1, 2, **kw), norm, patches=lambda rng: (
        img[None], np.ones((1,) + shape, bool), ball[None]))
    model = str(tmp_path / "model")
    save_checkpoint(model, 1, 0, net.state_dict(), "vnet", 16, 1, 2, [1.0] * 3,
                    "LINEAR", [norm], extra={"net_kwargs": kw})
    frame = Frame(np.array([-20.0, 15.0, 3.0]), np.array([0.75, 0.75, 1.5]), np.eye(3))
    write_dicom_series(str(tmp_path / "series"), img, frame)
    write_image(Volume(img, frame), str(tmp_path / "nifti" / "series.nii.gz"))
    part = ["--bf16", "--partition_type", "SIZE", "--partition_size", "32", "32", "32",
            "--partition_stride", "16", "16", "16"]
    before = tc.thin_conv3d.launches
    seg_infer(["-i", str(tmp_path / "series"), "-m", model, "-o", str(tmp_path / "gpu")]
              + part)
    assert tc.thin_conv3d.launches > before
    seg_infer(["-i", str(tmp_path / "nifti"), "-m", model, "-o", str(tmp_path / "nii")]
              + part)
    segmentation(str(tmp_path / "series"), model, str(tmp_path / "cpu"), device="cpu",
                 dtype=torch.bfloat16, fused=True, partition_type="SIZE",
                 partition_size=[32] * 3, partition_stride=[16] * 3)
    gpu, nii, cpu = (read_image(str(tmp_path / r / "series" / "seg.mha")).data
                     for r in ("gpu", "nii", "cpu"))
    np.testing.assert_array_equal(gpu, nii)
    assert np.mean(gpu == cpu) >= 0.999
    assert np.mean(gpu == ball) >= 0.98


@pytest.mark.cuda
def test_two_shards_on_one_card_match_unsharded(cuda_device):
    """Patch sharding and z-sharding with 2 shards on one card: each shard
    runs the folded forward's kernels on the shard stream's thread, and the
    merge waits for it. Probabilities within 1e-5 of the unsharded runs
    (sharding reassociates float32 sums), masks equal, 8 launches per
    batch or slab."""
    from segmentation3d_tpu_torch.core.infer_engine import SlidingWindowInferer
    from segmentation3d_tpu_torch.core.spatial_shard import SpatialShardedInferer
    net = SegmentationNet(1, 2, base_channels=4, down_convs=(1, 2),
                          up_convs=(2, 1)).eval().to(cuda_device)
    fwd = build_fused_forward(net, torch.bfloat16)
    vol = torch.from_numpy(np.random.default_rng(0).normal(
        size=(48, 32, 32, 1)).astype(np.float32)).to(cuda_device)
    shards = [cuda_device] * 2
    for make, kw in ((lambda d: SlidingWindowInferer(fwd, (16, 16, 16), 2, batch_size=2,
                                                     devices=d), dict(stride_zyx=(8, 8, 8))),
                     (lambda d: SpatialShardedInferer(fwd, 16, 2, d or [cuda_device],
                                                      stride_z=8), {})):
        ref_m, ref_p = make(None)(vol, return_prob=True, **kw)
        before = tc.thin_conv3d.launches
        m, p = make(shards)(vol, return_prob=True, **kw)
        torch.cuda.synchronize()
        assert (tc.thin_conv3d.launches - before) % 8 == 0
        assert tc.thin_conv3d.launches > before
        assert (p - ref_p).abs().max().item() <= 1e-5
        assert torch.equal(m, ref_m)
