"""SwinUNETR in the port against the benchmark's plain reference, on the CPU.

The port's ``models/swin_unetr.py`` and the plain float32 reference
``portbench/reference/swin_unetr.py`` (explicit ``softmax(q k^T / sqrt(d) +
B) v``, no fused attention) share one seeded state dict. A 64^3 input at
``feature_size`` 12 exercises every part of the net: the 32^3 token grid
pads to 35 (window 7), then 16 -> 21 and 8 -> 14 with the shift and mask,
a 4^3 grid clipped to one window without shift, every merge, and a last
hidden state of 2^3 (at 32^3 it would be 1^3, where InstanceNorm has a
single element and raises, in MONAI too). A 64 x 64 x 32 input adds a
stage where one axis is clipped while the others shift.
"""
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portbench import swin_flops, swin_weights
from portbench.cases import phantom, read_nifti, write_mha
from portbench.reference import pipeline
from portbench.reference.swin_unetr import SwinUNETR, low_net, region_labels
from segmentation3d_tpu_torch.cli.seg_infer import main as seg_infer
from segmentation3d_tpu_torch.cli.seg_serve import main as serve_main
from segmentation3d_tpu_torch.core import seg_infer as seg_infer_core
from segmentation3d_tpu_torch.core.seg_train import train, train_ranks
from segmentation3d_tpu_torch.core.serve import request
from segmentation3d_tpu_torch.models import create_network
from segmentation3d_tpu_torch.models.swin_unetr import (SegmentationNet, WindowAttention,
                                                        partition)
from segmentation3d_tpu_torch.utils import model_io, tracing
from segmentation3d_tpu_torch.utils.normalizer import FixedNormalizer
from phantoms import write_train_config

F = 12
NET = {"name": "swin_unetr", "in_channels": 1, "num_classes": 14, "feature_size": F,
       "depths": [2, 2, 2, 2], "num_heads": [3, 6, 12, 24], "window_size": 7}
CFG = {"net": NET, "spacing_mm": [1.5, 1.5, 2.0], "crop": [64, 64, 64],
       "normalizer": {"mean": 37.5, "stddev": 212.5, "clip": True}}
#: the port under bf16 autocast against the float32 reference, largest
#: logit gap over the largest logit: measured 0.020-0.038 on five seeds
#: and both shapes (CPU), while the reference with fp8 convolutions and
#: linear layers reads 0.18-0.32; the limit sits between with room on
#: both sides
BF16_TOL = 0.08


def nets(seed):
    """``(port, reference)`` in eval mode holding one seeded state dict."""
    ref = SwinUNETR(1, 14, F).eval()
    swin_weights._draw(ref, torch.Generator().manual_seed(seed))
    port = SegmentationNet(1, 14, feature_size=F).eval()
    port.load_state_dict(ref.state_dict(), strict=True)
    return port, ref


def ref_logits(ref, x):
    return ref(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)


SHAPES = [(64, 64, 64), (64, 64, 32)]


@pytest.mark.parametrize("shape", SHAPES)
def test_float32_forward_matches_the_reference(shape):
    """Elementwise within 1e-5 of the largest logit: both compute in float32
    with every product accumulated in float32, in other orders (fused
    attention against explicit products, library norms against written
    ones); measured 1.4e-6-2.4e-6 on three seeds."""
    port, ref = nets(seed=1)
    x = torch.randn((1,) + shape + (1,), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got, want = port(x, return_logits=True), ref_logits(ref, x)
    assert got.shape == (1,) + shape + (14,)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5
    with torch.no_grad():
        probs = port(x)
    torch.testing.assert_close(probs.sum(-1), torch.ones(probs.shape[:-1]))


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_autocast_within_its_tolerance_and_fp8_outside(shape):
    port, ref = nets(seed=3)
    x = torch.randn((1,) + shape + (1,), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want = ref_logits(ref, x)
        with torch.autocast("cpu", dtype=torch.bfloat16):
            got = port(x, return_logits=True)
        fp8 = ref_logits(low_net(ref, "fp8"), x)
    scale = want.abs().max()
    assert got.dtype == torch.float32
    assert float((got - want).abs().max() / scale) < BF16_TOL
    assert float((fp8 - want).abs().max() / scale) > BF16_TOL


def test_shifted_window_mask_zeroes_other_regions():
    """With the bias table at zero, a token of a shifted window gives no
    weight to tokens of another shifted region: each value carries its
    token's region one-hot, so the attention's output is the weight that
    each region receives."""
    grid, ws, ss = (14, 14, 14), (7, 7, 7), (3, 3, 3)
    attn = WindowAttention(32, 2, ws).eval()
    labels = region_labels(grid, ws, ss).view(grid)   # regions on the rolled grid
    onehot = torch.nn.functional.one_hot(labels, 32).float()
    with torch.no_grad():
        g = torch.Generator().manual_seed(5)
        attn.qkv.weight.copy_(torch.cat([torch.randn(64, 32, generator=g), torch.eye(32)]))
        attn.qkv.bias.zero_()
        attn.proj.weight.copy_(torch.eye(32))
        attn.proj.bias.zero_()
        out = attn(partition(onehot[None], ws), ws, ss, grid)       # [1, nW, N, 32]
    own = partition(onehot[None], ws)
    # head 0 carries the regions 0..15, head 1 the regions 16..31
    assert float((out * (1 - own)).abs().max()) < 1e-6
    assert float((out * own).sum(-1).min()) > 1 - 1e-5
    assert len(torch.unique(labels)) == 27


def test_flop_count_holds_the_attention_calls_and_the_forward():
    """The harness's count (portbench/swin_flops.py) against what the port
    runs: each attention call's windows, heads, tokens and mask; the
    windows counter and the spans of a traced forward; every conv, linear
    and attention product by forward hooks at the tiny size; and 637.05
    GFLOP for one 96^3 box at the published widths (padding costs the
    attention and its projections, not the MLPs: the padding is cropped
    after the attention)."""
    port, _ = nets(seed=6)
    patch, batch = (64, 64, 64), 2
    calls, flops = [], [0.0]
    real = torch.nn.functional.scaled_dot_product_attention

    def sdpa(q, k, v, attn_mask=None):
        calls.append((tuple(q.shape), tuple(attn_mask.shape)))
        flops[0] += 4.0 * q.shape[0] * q.shape[1] * q.shape[2] * k.shape[2] * q.shape[3]
        return real(q, k, v, attn_mask=attn_mask)

    def hook(m, i, o):
        if isinstance(m, torch.nn.ConvTranspose3d):
            flops[0] += 2.0 * o.numel() * m.in_channels
        elif isinstance(m, torch.nn.Conv3d):
            flops[0] += 2.0 * o.numel() * m.in_channels * m.weight[0, 0].numel()
        elif isinstance(m, torch.nn.Linear):
            flops[0] += 2.0 * o.numel() * m.in_features
    for m in port.modules():
        m.register_forward_hook(hook)
    torch.nn.functional.scaled_dot_product_attention = sdpa
    tracing.take()
    try:
        with torch.no_grad(), torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]):
            port(torch.zeros((batch,) + patch + (1,)))
    finally:
        torch.nn.functional.scaled_dot_product_attention = real
    taken = tracing.take()
    want = swin_flops.attention_calls(NET, patch)
    assert len(calls) == len(want) == 8
    for (q, mask), (_, _, windows, heads, n, shifted) in zip(calls, want):
        d = F // 3                             # the head width at every stage
        if shifted:
            assert q == (batch, windows * heads, n, d) and mask == (1, windows * heads, n, n)
        else:
            assert q == (batch * windows, heads, n, d) and mask == (1, heads, n, n)
    assert flops[0] == batch * swin_flops.forward_flops(NET, patch)
    assert taken.counters["swin.windows"] == batch * swin_flops.windows_per_box(NET, patch)
    names = [s.name for s in taken.spans]
    assert names.count("swin.window_attention") == 8 and names.count("swin.encoder") == 1
    full = dict(NET, feature_size=48)
    assert abs(swin_flops.forward_flops(full, (96, 96, 96)) / 1e9 - 637.05) < 1.0
    assert swin_flops.windows_per_box(full, (96, 96, 96)) == 832


def _write_model(model_dir, ref):
    model_io.save_checkpoint(model_dir, 0, 0, ref.state_dict(), "swin_unetr", 32, 1, 14,
                             CFG["spacing_mm"], "LINEAR",
                             [FixedNormalizer(mean=37.5, stddev=212.5, clip=True)],
                             extra={"net_kwargs": {k: NET[k] for k in (
                                 "feature_size", "depths", "num_heads", "window_size")}})
    return model_dir


@pytest.fixture(scope="module")
def swin_case(tmp_path_factory):
    """A tiny SwinUNETR checkpoint (head fitted to the phantom's tissues),
    a CT phantom of 60 x 72 x 72 voxels at 2.5 x 1.2 x 1.2 mm (75 x 58 x 58
    at the model's 2.0 x 1.5 x 1.5 mm, padded to 128 x 64 x 64: three 64^3
    boxes at stride 32), and the reference pipeline's probabilities."""
    root = tmp_path_factory.mktemp("swin")
    ref = swin_weights.seeded(SwinUNETR(1, 14, F), 11, CFG, torch.device("cpu"))
    model = _write_model(str(root / "model"), ref)
    spacing = (2.5, 1.2, 1.2)
    hu, _ = phantom((60, 72, 72), spacing, (0.0, 10.0, -20.0), torch.Generator().manual_seed(12))
    case = str(root / "case.mha")
    write_mha(case, hu.numpy(), spacing)
    traffic = {"shape_bucket": 64, "patch": [64, 64, 64], "stride": [32, 32, 32]}
    prob = pipeline.probabilities(ref, hu, spacing, CFG, traffic)
    return root, model, case, hu, spacing, prob


ENGINE = ["--partition_type", "SIZE", "--partition_size", "64", "64", "64",
          "--partition_stride", "32", "32", "32", "--batch_size", "2", "-g", "-1"]
#: the float32 program against the float32 reference pipeline: a written
#: class may lie below the reference's best by round-off alone (a
#: near-tie), by at most this much; measured 0 (every voxel the
#: reference's argmax), the probabilities 2.9e-6 apart on the iso grid
MASK_TOL = 1e-4


def test_seg_infer_mask_agrees_with_the_reference_pipeline(swin_case):
    root, model, case, hu, spacing, prob = swin_case
    res = seg_infer(["-i", case, "-m", model, "-o", str(root / "out"), "-n", "seg.nii.gz"]
                    + ENGINE)
    assert [r[0] for r in res] == ["case"]
    mask, sp = read_nifti(str(root / "out" / "case" / "seg.nii.gz"))
    assert mask.shape == tuple(hu.shape) and np.allclose(sp, spacing)
    gaps = pipeline.mask_gaps(prob, torch.from_numpy(mask.copy()), spacing,
                              tuple(CFG["spacing_mm"][::-1]))
    assert gaps["mask_gap"] <= MASK_TOL
    assert len(np.unique(mask)) >= 3          # the fitted head separates tissues


def test_the_rim_past_the_last_iso_centre_is_class_0_as_in_the_jax_package(swin_case):
    """Where the iso grid ends exactly at the volume's edge (no padding),
    the native voxels past the last iso centre fall outside the iso grid
    by the map back's rule (ITK's: a continuous index outside ``[0, n -
    1]``) and are written class 0, as the JAX package writes them; the
    port keeps that on purpose. The reference pipeline maps them to the
    last iso voxel instead, so the benchmark's pool pads every case.
    128 x 80 x 80 voxels at 1.0 x 1.2 x 1.2 mm are exactly 64^3 at the
    model's 2.0 x 1.5 x 1.5 mm: the last z slice, y row and x column are
    the rim, and every other voxel agrees with the reference."""
    from segmentation3d_tpu.ops import geometry as jg
    from segmentation3d_tpu.ops import resample as jr
    from segmentation3d_tpu_torch.ops import geometry as tg
    from segmentation3d_tpu_torch.ops import resample as tr
    root, model, *_ = swin_case
    spacing, shape = (1.0, 1.2, 1.2), (128, 80, 80)
    hu, _ = phantom(shape, spacing, (0.0, 10.0, -20.0), torch.Generator().manual_seed(13))
    case = str(root / "edge.mha")
    write_mha(case, hu.numpy(), spacing)
    seg_infer(["-i", case, "-m", model, "-o", str(root / "edge"), "-n", "seg.nii.gz"]
              + ENGINE)
    mask, _ = read_nifti(str(root / "edge" / "edge" / "seg.nii.gz"))
    rim = np.zeros(shape, bool)
    rim[-1], rim[:, -1], rim[:, :, -1] = True, True, True
    assert (mask[rim] == 0).all()
    ref = swin_weights.seeded(SwinUNETR(1, 14, F), 11, CFG, torch.device("cpu"))
    traffic = {"shape_bucket": 64, "patch": [64, 64, 64], "stride": [32, 32, 32]}
    prob = pipeline.probabilities(ref, hu, spacing, CFG, traffic)
    assert tuple(prob.shape[1:]) == (64, 64, 64)
    inner = torch.from_numpy(mask[:-1, :-1, :-1].copy())
    gaps = pipeline.mask_gaps(prob, inner, spacing, tuple(CFG["spacing_mm"][::-1]))
    assert gaps["mask_gap"] <= MASK_TOL
    # the JAX package's map back of an iso label map with no class 0 on
    # this geometry: the same labels, and 0 on the rim alone
    labels = np.random.default_rng(14).integers(1, 14, (64, 64, 64)).astype(np.int32)
    sp_xyz, size_xyz = spacing[::-1], shape[::-1]
    back = {}
    for geo, res, conv in ((tg, tr, torch.from_numpy), (jg, jr, jnp.asarray)):
        native = geo.Frame((0.0, 0.0, 0.0), sp_xyz, np.eye(3))
        iso, iso_size = geo.resampled_frame(native, size_xyz, CFG["spacing_mm"], 32)
        assert tuple(iso_size) == (64, 64, 64)
        kind, coeffs, out_shape = res.resample_plan(iso, native, size_xyz)
        back[geo] = np.asarray(res.resample_exec(conv(labels), kind, conv(coeffs), out_shape,
                                                 interp=res.NN, fill=0.0))
    np.testing.assert_array_equal(back[tg], back[jg])
    np.testing.assert_array_equal(back[tg] == 0, rim)


def test_seg_serve_answers_with_the_same_mask(swin_case):
    root, model, case, *_ = swin_case
    seg_infer(["-i", case, "-m", model, "-o", str(root / "cli"), "-n", "seg.nii.gz"]
              + ENGINE)
    sock = str(root / "s.sock")
    t = threading.Thread(target=serve_main, daemon=True, args=(
        ["-m", model, "--socket", sock, "-n", "seg.nii.gz"] + ENGINE,))
    t.start()
    for _ in range(600):
        if os.path.exists(sock):
            break
        t.join(0.05)
    try:
        r = request(sock, {"input": case, "output_dir": str(root / "served")})
        assert r["ok"], r
    finally:
        request(sock, {"cmd": "shutdown"}, timeout=10)
        t.join(10)
    served, _ = read_nifti(str(root / "served" / "case" / "seg.nii.gz"))
    direct, _ = read_nifti(str(root / "cli" / "case" / "seg.nii.gz"))
    np.testing.assert_array_equal(served, direct)


def test_int8_on_swin_unetr_raises(swin_case):
    root, model, case, *_ = swin_case
    with pytest.raises(ValueError, match="requires the packed-domain forward"):
        seg_infer(["-i", case, "-m", model, "-o", str(root / "int8"), "--int8"] + ENGINE)


@pytest.mark.parametrize("entry", [train, train_ranks])
def test_seg_train_refuses_swin_unetr(tmp_path, entry):
    """Before anything is built or spawned: the trainer keeps only V-Net
    keys and would build a default SwinUNETR from the dropped ones."""
    cfg = write_train_config(str(tmp_path / "cfg.py"), str(tmp_path / "none.txt"),
                             str(tmp_path / "save"), num_classes=14, crop_size=(64, 64, 64),
                             extra='__C.net.name = "swin_unetr"\n')
    with pytest.raises(NotImplementedError, match="training 'swin_unetr' is not supported"):
        entry(cfg, gpu_id=-1)
    assert not os.path.exists(str(tmp_path / "save"))


@pytest.mark.parametrize("name, kw, dtype, fused, quant, builder", [
    ("vnet", {}, torch.bfloat16, True, None, "build_fused_forward"),
    ("vnet", {}, torch.float32, None, None, "module_forward"),
    ("vnet", {"act": "prelu"}, torch.bfloat16, True, None, "build_fused_forward"),
    ("vnet", {}, torch.bfloat16, None, "int8", "build_int8_forward"),
    ("vnet", {"act": "leaky_relu"}, torch.bfloat16, True, None, "module_forward"),
    ("vbnet", {}, torch.bfloat16, True, None, "build_fused_forward"),
    ("vbnet", {"act": "leaky_relu"}, torch.bfloat16, True, None, "module_forward"),
    ("swin_unetr", {"feature_size": 12}, torch.bfloat16, True, None, "module_forward"),
])
def test_build_forward_picks_the_same_forward(name, kw, dtype, fused, quant, builder):
    """Each net's forward: V-Net and VB-Net with relu or prelu fold;
    leaky_relu and SwinUNETR run the module."""
    if name != "swin_unetr":
        kw = dict(kw, base_channels=4, down_convs=(1, 2), up_convs=(2, 1))
    net = create_network(name, 1, 14 if name == "swin_unetr" else 2, **kw).eval()
    forward = seg_infer_core.build_forward(net, dtype, torch.device("cpu"), fused=fused,
                                           quant=quant)
    assert forward.__qualname__.split(".")[0] == builder
