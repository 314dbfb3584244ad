"""The bottleneck V-Net (``vbnet``) in the port against the flax vbnet and
the JAX package's segmentation() on the CPU, on the same seeded weights.

Bars: the module in float32 within 1e-4 of flax (tests/test_torch_port_vnet.py's
bar); seg_infer masks by tests/test_torch_port_seg_infer.py's rule and
probability maps within 2e-3. The folded forward (which the JAX package
lacks for vbnet) in float32 rounds each kernel conv's operands to bf16, as
V-Net's fold does; V-Net's bar, max(0.02, 1.5 x a witness's error), holds
it against flax and the module, with the module that rounds every 3^3
conv's input and weight to bf16 as the witness (V-Net's is the JAX fused
forward), and argmax agreement > 0.99; in bf16, argmax agreement > 0.98
against flax float32. As in the JAX package, --int8 raises for vbnet.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phantoms import make_sphere_case
from segmentation3d_tpu.core.seg_infer import segmentation as jax_segmentation
from segmentation3d_tpu.io import read_image as jax_read
from segmentation3d_tpu.models.vbnet import SegmentationNet as JaxVBNet
from segmentation3d_tpu.utils import model_io as jax_io
from segmentation3d_tpu.utils.normalizer import AdaptiveNormalizer
from segmentation3d_tpu_torch.cli.seg_infer import main as seg_infer
from segmentation3d_tpu_torch.core import seg_infer as seg_infer_core
from segmentation3d_tpu_torch.core.seg_infer import load_seg_model, segmentation
from segmentation3d_tpu_torch.models import get_network_module
from segmentation3d_tpu_torch.models import fused_vnet
from segmentation3d_tpu_torch.models.fused_vnet import build_fused_forward
from segmentation3d_tpu_torch.models.quant_vnet import build_int8_forward
from segmentation3d_tpu_torch.ops import thin_conv, window_i8
from segmentation3d_tpu_torch.utils import model_io
from test_torch_port_checkpoint import KW, seeded_variables
from test_torch_port_pipeline import assert_same_mask

VKW = dict(base_channels=8, down_convs=(1, 2), up_convs=(2, 1))
#: chains of 3 and 1 blocks (VKW: 1 and 2)
VKW3 = dict(base_channels=8, down_convs=(3, 1), up_convs=(1, 3))


def vb_variables(act="relu", seed=0, kw=VKW):
    """(flax variables, port vbnet) with the same seeded weights."""
    return seeded_variables(act, seed=seed, kw=dict(kw, bottleneck=True))


def save_vbnet(path, act="relu", seed=0):
    v, _ = vb_variables(act, seed)
    jax_io.save_checkpoint(str(path), 2, 0, v, "vbnet", 4, 1, 2,
                           [1.0, 1.0, 1.0], "LINEAR", [AdaptiveNormalizer()],
                           extra={"net_kwargs": dict(VKW, act=act)})
    return str(path)


@pytest.mark.parametrize("act", ["relu", "prelu"])
def test_module_matches_flax_vbnet(act):
    v, net = vb_variables(act, seed=1)
    assert net.bottleneck and "down_16.res.conv0.reduce.conv.weight" in net.state_dict()
    x = np.random.default_rng(1).normal(size=(2, 16, 16, 16, 1)).astype(np.float32)
    jnet = JaxVBNet(in_channels=1, out_channels=2, act=act, **VKW)
    ref = np.asarray(jnet.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_params_from_jax_on_a_flax_vbnet_init():
    jnet = JaxVBNet(in_channels=1, out_channels=2, act="prelu", **VKW)
    init = jax.jit(lambda k, x: jnet.init(k, x, train=False))
    v = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(3),
                                                jnp.zeros((1, 16, 16, 16, 1))))
    state = model_io.params_from_jax(v)
    net = get_network_module("vbnet").SegmentationNet(1, 2, act="prelu", **VKW)
    net.load_state_dict(state, strict=True)
    assert "up_32.res.act0.alpha" in state  # the chain's inner activation
    assert model_io.layouts_of(net.state_dict()) == jax_io.flatten_variables(v)[1]


@pytest.mark.parametrize("act", ["relu", "prelu"])
def test_jax_vbnet_checkpoint_loads_strictly(tmp_path, act):
    model = load_seg_model(save_vbnet(tmp_path, act, seed=2), torch.device("cpu"))
    assert model.net_name == "vbnet" and model.net.bottleneck
    assert model.net.act == act and model.epoch_idx == 2


def test_folded_forwards_refuse_vbnet():
    """The BN-folded forward builds for vbnet; the int8 forward and its
    calibration's ``stats`` forward refuse it, as the JAX package's packed
    forward does; a leaky_relu vbnet runs the module."""
    _, net = vb_variables()
    x = torch.zeros((1, 16, 16, 16, 1))
    assert build_fused_forward(net)(x).shape == (1, 16, 16, 16, 2)
    with pytest.raises(NotImplementedError, match="non-bottleneck"):
        build_fused_forward(net, stats=True)
    with pytest.raises(NotImplementedError, match="non-bottleneck"):
        build_int8_forward(net)
    _, leaky = vb_variables("leaky_relu")
    forward = seg_infer_core.build_forward(leaky, torch.bfloat16, torch.device("cpu"),
                                           fused=True)
    assert forward.__qualname__.split(".")[0] == "module_forward"


def _flax_vbnet(v, act, kw, x):
    jnet = JaxVBNet(in_channels=1, out_channels=2, act=act, **kw)
    return np.asarray(jnet.apply(v, jnp.asarray(x), train=False))


def _bf16_operands_module(net, x):
    """The module in float32 with every 3^3 conv's input and weight rounded
    to bf16, as the kernel rounds its operands: what that rounding alone
    moves the output by."""
    def r(t):
        return t.to(torch.bfloat16).to(torch.float32)
    convs = [m for m in net.modules()
             if isinstance(m, torch.nn.Conv3d) and m.kernel_size == (3, 3, 3)]
    saved = [m.weight.data for m in convs]
    hooks = [m.register_forward_pre_hook(lambda _, inp: (r(inp[0]),)) for m in convs]
    for m in convs:
        m.weight.data = r(m.weight.data)
    try:
        with torch.no_grad():
            return net(x).numpy()
    finally:
        for m, w in zip(convs, saved):
            m.weight.data = w
        for h in hooks:
            h.remove()


@pytest.mark.parametrize("kw", [VKW, VKW3], ids=["chains12", "chains31"])
@pytest.mark.parametrize("act", ["relu", "prelu"])
def test_folded_vbnet_f32_matches_module_and_flax(act, kw):
    v, net = vb_variables(act, seed=5, kw=kw)
    x = np.random.default_rng(5).normal(size=(2, 16, 16, 16, 1)).astype(np.float32)
    flax_out = _flax_vbnet(v, act, kw, x)
    with torch.no_grad():
        module = net(torch.from_numpy(x)).numpy()
    before = thin_conv.thin_conv3d.launches
    fwd = build_fused_forward(net, dtype=torch.float32)
    got = fwd(torch.from_numpy(x)).numpy()
    assert thin_conv.thin_conv3d.launches == before  # CPU tensors: plain version
    assert fwd.capturable is False  # only a CUDA device's forward is
    witness = _bf16_operands_module(net, torch.from_numpy(x))
    atol = max(0.02, 1.5 * float(np.abs(witness - flax_out).max()))
    np.testing.assert_allclose(got, flax_out, atol=atol)
    np.testing.assert_allclose(got, module, atol=atol)
    assert np.mean(np.argmax(got, -1) == np.argmax(flax_out, -1)) > 0.99


def test_folded_vbnet_routes_mid_convs_by_shape(monkeypatch):
    """Stem, head and the mid convs of 8, 32 and 64 channels through
    thin_conv3d; those of 16 channels through cuDNN: base 32 gives mid 16
    (64-channel levels) and mid 32 (128); the float32 fold stays within
    V-Net's bar of the module."""
    kw = dict(base_channels=32, down_convs=(1, 1), up_convs=(1, 1))
    _, net = vb_variables("prelu", seed=7, kw=kw)
    calls = []
    real = fused_vnet.thin_conv3d

    def spy(x, w, *a, **k):
        calls.append(tuple(w.shape))
        return real(x, w, *a, **k)
    monkeypatch.setattr(fused_vnet, "thin_conv3d", spy)
    x = torch.from_numpy(np.random.default_rng(7).normal(
        size=(1, 16, 16, 16, 1)).astype(np.float32))
    got = build_fused_forward(net, dtype=torch.float32)(x).numpy()
    assert calls == [(3, 3, 3, 1, 32), (3, 3, 3, 32, 32), (3, 3, 3, 32, 32),
                     (3, 3, 3, 64, 2)]
    assert [fused_vnet._mid_on_cudnn(c, c) for c in (8, 16, 32, 64)] == \
        [False, True, False, False]
    with torch.no_grad():
        module = net(x).numpy()
    witness = _bf16_operands_module(net, x)
    atol = max(0.02, 1.5 * float(np.abs(witness - module).max()))
    np.testing.assert_allclose(got, module, atol=atol)


@pytest.mark.parametrize("act", ["relu", "prelu"])
def test_folded_vbnet_bf16_argmax(act):
    v, net = vb_variables(act, seed=6, kw=VKW3)
    x = np.random.default_rng(6).normal(size=(2, 16, 16, 16, 1)).astype(np.float32)
    flax_out = _flax_vbnet(v, act, VKW3, x)
    got = build_fused_forward(net, dtype=torch.bfloat16)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == flax_out.shape
    assert np.mean(np.argmax(got.numpy(), -1) == np.argmax(flax_out, -1)) > 0.98


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("vbnet"))
    imgs, _ = make_sphere_case(d, "case", shape_zyx=(30, 34, 28),
                               spacing=(1.1, 0.9, 1.3))
    return d, imgs[0], save_vbnet(os.path.join(d, "model"), seed=4)


def test_seg_infer_vbnet_matches_jax(case):
    d, img, model = case
    jax_segmentation(img, model, os.path.join(d, "jax"), save_prob=True)
    res = seg_infer(["-i", img, "-m", model, "-o", os.path.join(d, "port"),
                     "-g", "-1", "--save_prob"])
    assert [r[0] for r in res] == ["case_mod0"]
    assert_same_mask(os.path.join(d, "port"), os.path.join(d, "jax"))


def test_bf16_vbnet_runs_the_module(case):
    """--bf16 on the CPU runs vbnet's nn.Module under autocast (the fold is
    a CUDA device's, as V-Net's is): no kernel launch; its mask agrees with
    float32 on >= 98% of voxels."""
    d, img, model = case
    before = thin_conv.thin_conv3d.launches
    seg_infer(["-i", img, "-m", model, "-o", os.path.join(d, "bf16"), "-g", "-1",
               "--bf16"])
    seg_infer(["-i", img, "-m", model, "-o", os.path.join(d, "f32"), "-g", "-1"])
    assert thin_conv.thin_conv3d.launches == before
    a, b = (jax_read(os.path.join(d, r, "case_mod0", "seg.mha")).data
            for r in ("bf16", "f32"))
    assert np.mean(a == b) >= 0.98


def test_int8_vbnet_raises_jax_error(case):
    d, img, model = case
    with pytest.raises(ValueError) as ref:
        jax_segmentation(img, model, os.path.join(d, "jax_int8"), quant="int8",
                         fused=True, dtype=jnp.bfloat16)
    before = window_i8.window_conv_i8.launches
    with pytest.raises(ValueError) as got:
        seg_infer(["-i", img, "-m", model, "-o", os.path.join(d, "port_int8"),
                   "-g", "-1", "--int8"])
    assert "packed-domain forward" in str(ref.value)
    assert str(got.value) == str(ref.value)
    assert window_i8.window_conv_i8.launches == before


def test_int8_calib_vbnet_raises_before_calibrating(case, monkeypatch):
    d, img, model = case

    def calibrate(*a, **k):
        raise AssertionError("calibrated a vbnet")
    monkeypatch.setattr(seg_infer_core, "_calibrate_for_model", calibrate)
    with pytest.raises(ValueError, match="requires the packed-domain forward"):
        seg_infer(["-i", img, "-m", model, "-o", os.path.join(d, "port_calib"),
                   "-g", "-1", "--int8", "--int8_calib", img])


def test_folded_vbnet_through_segmentation(case):
    """The fold forced on the CPU (``fused=True``) through the engine: the
    mask agrees with the float32 module's on >= 98% of voxels."""
    d, img, model = case
    segmentation(img, model, os.path.join(d, "fold"), dtype=torch.bfloat16,
                 device="cpu", fused=True)
    segmentation(img, model, os.path.join(d, "f32_lib"), device="cpu")
    a, b = (jax_read(os.path.join(d, r, "case_mod0", "seg.mha")).data
            for r in ("fold", "f32_lib"))
    assert np.mean(a == b) >= 0.98


def test_vnet_kwargs_still_build_a_plain_vnet():
    net = get_network_module("vnet").SegmentationNet(1, 2, **KW)
    assert not net.bottleneck
    assert not any(".reduce." in k for k in net.state_dict())
