"""The bottleneck V-Net (``vbnet``) in the port against the flax vbnet and
the JAX package's segmentation() on the CPU, on the same seeded weights.

Bars: the module in float32 within 1e-4 of flax (tests/test_torch_port_vnet.py's
bar); seg_infer masks by tests/test_torch_port_seg_infer.py's rule and
probability maps within 2e-3. As in the JAX package, vbnet has no folded
forward: bf16 runs the nn.Module (no kernel launch) and --int8 raises.
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
from segmentation3d_tpu_torch.core.seg_infer import load_seg_model
from segmentation3d_tpu_torch.models import get_network_module
from segmentation3d_tpu_torch.models.fused_vnet import build_fused_forward
from segmentation3d_tpu_torch.models.quant_vnet import build_int8_forward
from segmentation3d_tpu_torch.ops import thin_conv, window_i8
from segmentation3d_tpu_torch.utils import model_io
from test_torch_port_checkpoint import KW, seeded_variables
from test_torch_port_pipeline import assert_same_mask

VKW = dict(base_channels=8, down_convs=(1, 2), up_convs=(2, 1))


def vb_variables(act="relu", seed=0):
    """(flax variables, port vbnet) with the same seeded weights."""
    return seeded_variables(act, seed=seed, kw=dict(VKW, bottleneck=True))


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
    _, net = vb_variables()
    with pytest.raises(NotImplementedError, match="non-bottleneck"):
        build_fused_forward(net)
    with pytest.raises(NotImplementedError, match="non-bottleneck"):
        build_int8_forward(net)


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
    """--bf16 takes JAX's route for vbnet, the nn.Module under autocast:
    no kernel launch; its mask agrees with float32 on >= 98% of voxels."""
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


def test_vnet_kwargs_still_build_a_plain_vnet():
    net = get_network_module("vnet").SegmentationNet(1, 2, **KW)
    assert not net.bottleneck
    assert not any(".reduce." in k for k in net.state_dict())
