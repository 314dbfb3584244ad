"""Checkpoints cross between the JAX package and the PyTorch port: a
JAX-written params.pth loads strictly into the port's module, a port-written
one loads in JAX's load_seg_model, and params_from_jax round-trips."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation3d_tpu.core.seg_infer import load_seg_model as jax_load_seg_model
from segmentation3d_tpu.models.vnet import SegmentationNet as JaxNet
from segmentation3d_tpu.utils import model_io as jax_io
from segmentation3d_tpu.utils.normalizer import AdaptiveNormalizer as JaxAdaptive
from segmentation3d_tpu_torch.core.seg_infer import load_seg_model
from segmentation3d_tpu_torch.models.vnet import SegmentationNet
from segmentation3d_tpu_torch.utils import model_io
from segmentation3d_tpu_torch.utils.normalizer import FixedNormalizer

KW = dict(base_channels=4, down_convs=(1, 2), up_convs=(2, 1))


def seeded_variables(act="relu", in_ch=1, out_ch=2, seed=0, kw=KW,
                     spread=0.1):
    """(flax variables, port net) holding the same seeded weights: conv
    weights He-scaled normals (flax's init), BatchNorm statistics and
    biases off the identity by ``spread`` (0: flax's init), so folding
    them matters. Built
    from the port's module and mapped with the JAX package's own
    unflatten_state_dict, which is quicker than a flax init."""
    net = SegmentationNet(in_ch, out_ch, act=act, **kw).eval()
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in net.state_dict().items():
            if name.endswith("num_batches_tracked"):
                continue
            if name.endswith("alpha"):
                a = rng.uniform(0.1, 0.4, t.shape)
            elif t.dim() == 5:
                fan_in = t.shape[0] if "up_conv" in name else t[0].numel()
                a = rng.normal(size=t.shape) * (2.0 / fan_in) ** 0.5
            elif name.endswith("running_var") or name.endswith("bn.weight"):
                a = rng.uniform(1.0 - spread, 1.0 + spread, t.shape)
            else:  # biases, running means
                a = rng.normal(size=t.shape) * spread / 2
            t.copy_(torch.from_numpy(a.astype(np.float32)))
    sd = {k: t.numpy() for k, t in net.state_dict().items()}
    variables = jax_io.unflatten_state_dict(sd, model_io.layouts_of(net.state_dict()))
    return variables, net


def jax_net(act="relu", in_ch=1, out_ch=2, kw=KW):
    return JaxNet(in_channels=in_ch, out_channels=out_ch, act=act, **kw)


@pytest.mark.parametrize("act", ["relu", "prelu"])
def test_jax_checkpoint_loads_strictly(tmp_path, act):
    v, _ = seeded_variables(act)
    jax_io.save_checkpoint(str(tmp_path), 3, 0, v, "vnet", 4, 1, 2,
                           [1.0, 1.0, 1.0], "LINEAR", [JaxAdaptive()],
                           extra={"net_kwargs": dict(KW, act=act)})
    payload = model_io.load_checkpoint_payload(
        model_io.resolve_checkpoint(str(tmp_path)))
    net = SegmentationNet(1, 2, act=act, **KW)
    net.load_state_dict(payload["state_dict"], strict=True)
    if act == "prelu":
        assert net.in_block.conv.act.alpha.shape == (1,)
        assert "up_8.res.act_out.alpha" in payload["state_dict"]
    assert "up_8.res.conv0.bn.num_batches_tracked" in payload["state_dict"]
    model = load_seg_model(str(tmp_path), torch.device("cpu"))
    assert model.epoch_idx == 3 and model.net.act == act
    assert model.normalizers[0].to_dict() == JaxAdaptive().to_dict()


@pytest.mark.parametrize("act", ["relu", "prelu"])
def test_port_checkpoint_loads_in_jax(tmp_path, act):
    _, net = seeded_variables(act, seed=1)
    model_io.save_checkpoint(str(tmp_path), 2, 5, net.state_dict(), "vnet", 4,
                             1, 2, [1.0, 1.0, 1.0], "LINEAR",
                             [FixedNormalizer(10.0, 20.0)],
                             extra={"net_kwargs": dict(KW, act=act)})
    jm = jax_load_seg_model(str(tmp_path))
    x = np.random.default_rng(0).normal(size=(1, 16, 16, 16, 1)).astype(np.float32)
    ref = np.asarray(jm.net.apply(jm.variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert jm.normalizers[0].to_dict() == FixedNormalizer(10.0, 20.0).to_dict()


def test_params_from_jax_round_trips():
    """On a genuine flax init (prelu: every parameter kind)."""
    act = "prelu"
    init = jax.jit(lambda k, x: jax_net(act).init(k, x, train=False))
    v = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(2),
                                                jnp.zeros((1, 16, 16, 16, 1))))
    state = model_io.params_from_jax(v)
    ref_state, ref_layouts = jax_io.flatten_variables(v)
    assert set(state) == set(ref_state)
    net = SegmentationNet(1, 2, act=act, **KW)
    net.load_state_dict(state, strict=True)
    sd = {k: t.numpy() for k, t in net.state_dict().items()}
    assert model_io.layouts_of(net.state_dict()) == ref_layouts
    back = jax_io.unflatten_state_dict(sd, ref_layouts)
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(v))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(leaf, flat_b[path])


def test_checkpoint_selection(tmp_path):
    net = SegmentationNet(1, 2, **KW)
    for e in (1, 10, 2):
        model_io.save_checkpoint(str(tmp_path), e, 0, net.state_dict(), "vnet",
                                 4, 1, 2, [1, 1, 1], "LINEAR", [])
    assert model_io.latest_checkpoint(str(tmp_path)).endswith("chk_10")
    assert model_io.resolve_checkpoint(str(tmp_path), "2").endswith("chk_2")
    assert jax_io.latest_checkpoint(str(tmp_path)) == \
        model_io.latest_checkpoint(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        model_io.resolve_checkpoint(str(tmp_path), "best")
    with pytest.raises(ValueError):
        model_io.resolve_checkpoint(str(tmp_path), "newest")


def test_bottleneck_is_refused():
    """The bottleneck net (vbnet) builds, but the folded forwards refuse it,
    as the JAX package's fused and packed forwards do; it runs as the
    nn.Module (tests/test_torch_port_vbnet.py)."""
    from segmentation3d_tpu_torch.models.fused_vnet import build_fused_forward
    from segmentation3d_tpu_torch.models.quant_vnet import build_int8_forward
    net = SegmentationNet(1, 2, bottleneck=True, **KW)
    for build in (build_fused_forward, build_int8_forward):
        with pytest.raises(NotImplementedError):
            build(net)
