"""Checkpoints trained by the original PyTorch toolkit, in the port: the
positional importer against the JAX package's, load_seg_model's fallback
through segmentation() against JAX's, and seg_convert across both packages.

The same foreign-named state_dict goes through both importers; the port's
result must equal ``model_io.flatten_variables`` of the JAX result key for
key (order included) and exactly. Forwards are held to the bar of
tests/test_torch_import.py: 2e-4 and argmax agreement 1.0.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phantoms import make_sphere_case
from torch_vnet_ref import TorchVNet
from segmentation3d_tpu.cli.seg_convert import convert_checkpoint as jax_convert
from segmentation3d_tpu.compat.torch_import import (
    import_torch_state_dict as jax_import, template_entries as jax_template)
from segmentation3d_tpu.core.seg_infer import load_seg_model as jax_load_seg_model
from segmentation3d_tpu.core.seg_infer import segmentation as jax_segmentation
from segmentation3d_tpu.io import read_image as jax_read
from segmentation3d_tpu.models.vnet import SegmentationNet as JaxNet
from segmentation3d_tpu.utils import model_io as jax_io
from segmentation3d_tpu_torch.cli.seg_convert import convert_checkpoint
from segmentation3d_tpu_torch.compat.torch_import import import_torch_state_dict
from segmentation3d_tpu_torch.core.seg_infer import load_seg_model, segmentation
from segmentation3d_tpu_torch.models.vnet import SegmentationNet

SMALL = dict(base_channels=4, down_convs=(1, 2), up_convs=(2, 1))
X_SHAPE = (1, 16, 16, 16, 1)


def _randomize_bn(tnet, seed):
    """BN statistics off the identity, as tests/test_torch_import.py does,
    so the statistics stream is exercised."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in tnet.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                m.running_mean.copy_(torch.rand(m.running_mean.shape, generator=g) - 0.5)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) * 1.5 + 0.5)
    return tnet


def _torch_vnet(seed=0):
    torch.manual_seed(seed)
    tnet = TorchVNet(in_ch=1, out_ch=2, base=4, down_convs=SMALL["down_convs"],
                     up_convs=SMALL["up_convs"])
    return _randomize_bn(tnet.eval(), seed)


def _renamed_jax_state(kw, seed):
    """A JAX-written state_dict (a flax init, flattened in its own order; BN
    statistics randomized) under foreign names that keep only each tensor's
    last name part."""
    _, v = jax_template(JaxNet(in_channels=1, out_channels=2, **kw), X_SHAPE)
    rng = np.random.default_rng(seed)
    state, _ = jax_io.flatten_variables(v)
    for k in state:
        if k.endswith("running_mean"):
            state[k] = rng.uniform(-0.5, 0.5, state[k].shape).astype(np.float32)
        elif k.endswith("running_var"):
            state[k] = rng.uniform(0.5, 2.0, state[k].shape).astype(np.float32)
    return {f"module.layer{i}.whatever_{k.split('.')[-1]}": torch.tensor(a)
            for i, (k, a) in enumerate(state.items())}


CASES = {
    # a genuine torch V-Net (torch's interleaved order)
    "torch_vnet": (SMALL, lambda: _torch_vnet().state_dict()),
    "prelu_vnet": (dict(SMALL, act="prelu"),
                   lambda: _renamed_jax_state(dict(SMALL, act="prelu"), 1)),
    "vbnet": (dict(SMALL, bottleneck=True),
              lambda: _renamed_jax_state(dict(SMALL, bottleneck=True), 2)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_import_equals_jax_importer(case):
    kw, make_sd = CASES[case]
    sd = make_sd()
    jnet = JaxNet(in_channels=1, out_channels=2, **kw)
    jv = jax_import(sd, jnet, X_SHAPE)
    ref, _ = jax_io.flatten_variables(jv)
    net = SegmentationNet(1, 2, **kw).eval()
    got = import_torch_state_dict(sd, net)
    assert list(got) == list(ref)
    for k, a in ref.items():
        t = got[k].numpy()
        assert t.dtype == a.dtype and t.shape == a.shape, k
        np.testing.assert_array_equal(t, a, err_msg=k)
    net.load_state_dict(got, strict=True)

    x = np.random.default_rng(0).normal(size=X_SHAPE).astype(np.float32)
    with torch.no_grad():
        ours = net(torch.from_numpy(x)).numpy()
    theirs = np.asarray(jnet.apply(jax.tree_util.tree_map(jnp.asarray, jv),
                                   jnp.asarray(x), train=False))
    if case == "torch_vnet":
        with torch.no_grad():
            ref_out = _torch_vnet()(torch.from_numpy(x.transpose(0, 4, 1, 2, 3)))
        ref_out = ref_out.numpy().transpose(0, 2, 3, 4, 1)
        np.testing.assert_allclose(theirs, ref_out, atol=2e-4)
    else:
        ref_out = theirs
    np.testing.assert_allclose(ours, ref_out, atol=2e-4)
    assert np.mean(np.argmax(ours, -1) == np.argmax(ref_out, -1)) == 1.0


def test_import_rejects_wrong_count_and_shape():
    net = SegmentationNet(1, 2, **SMALL)
    items = list(_torch_vnet().state_dict().items())
    with pytest.raises(ValueError, match="structural mismatch"):
        import_torch_state_dict(dict(items[1:]), net)
    bad = dict(items)
    bad[items[0][0]] = torch.zeros(1, 2, 3)
    with pytest.raises(ValueError, match="shape mismatch"):
        import_torch_state_dict(bad, net)


def _write_toolkit_checkpoint(model_dir, tnet, kw, max_stride):
    """``params.pth`` as the original toolkit saves it: torch.save of the
    self-describing payload, foreign module names, no _kernel_layouts."""
    payload = {
        "epoch_idx": 100, "batch_idx": 999, "net": "vnet",
        "max_stride": max_stride, "state_dict": tnet.state_dict(),
        "spacing": [1.0, 1.0, 1.0], "interpolation": "LINEAR",
        "in_channels": 1, "out_channels": 2,
        "crop_normalizers": [{"type": 0, "mean": 0.0, "stddev": 200.0,
                              "clip": True}],
        "net_kwargs": kw,
    }
    chk = os.path.join(model_dir, "checkpoints", "chk_100")
    os.makedirs(chk)
    torch.save(payload, os.path.join(chk, "params.pth"))


@pytest.fixture(scope="module")
def toolkit_model(tmp_path_factory):
    """A toolkit checkpoint of a seeded TorchVNet whose head bias puts its
    decision halfway between the phantom's sphere and background (so the
    mask has both labels, away from argmax ties), and the phantom."""
    d = str(tmp_path_factory.mktemp("toolkit"))
    imgs, seg = make_sphere_case(d, "case", shape_zyx=(24, 28, 20))
    tnet = _torch_vnet(seed=3)
    x = np.clip(jax_read(imgs[0]).data / 200.0, -1.0, 1.0)
    with torch.no_grad():
        p = tnet(torch.from_numpy(x[None, None].astype(np.float32)))[0]
    gap = (torch.log(p[1]) - torch.log(p[0])).numpy()
    fg = jax_read(seg).data > 0
    with torch.no_grad():
        tnet.proj.bias[1] -= float(np.median(gap[fg]) + np.median(gap[~fg])) / 2
    kw = dict(base_channels=4, down_convs=[1, 2], up_convs=[2, 1])
    _write_toolkit_checkpoint(os.path.join(d, "ref"), tnet, kw, 4)
    return d, tnet, imgs[0]


def _forward_gap(net_apply, tnet):
    x = np.random.default_rng(1).normal(size=X_SHAPE).astype(np.float32)
    with torch.no_grad():
        ref = tnet(torch.from_numpy(x.transpose(0, 4, 1, 2, 3))).numpy()
    ref = ref.transpose(0, 2, 3, 4, 1)
    got = net_apply(x)
    np.testing.assert_allclose(got, ref, atol=2e-4)
    assert np.mean(np.argmax(got, -1) == np.argmax(ref, -1)) == 1.0


def test_load_seg_model_fallback_segments_like_jax(toolkit_model):
    d, tnet, img = toolkit_model
    model_dir = os.path.join(d, "ref")
    model = load_seg_model(model_dir, torch.device("cpu"))
    assert model.epoch_idx == 100

    def apply(x):
        with torch.no_grad():
            return model.net(torch.from_numpy(x)).numpy()
    _forward_gap(apply, tnet)

    jax_segmentation(img, model_dir, os.path.join(d, "jax_out"))
    res = segmentation(img, model_dir, os.path.join(d, "port_out"), device="cpu")
    assert [r[0] for r in res] == ["case_mod0"]
    ref = jax_read(os.path.join(d, "jax_out", "case_mod0", "seg.mha")).data
    got = jax_read(os.path.join(d, "port_out", "case_mod0", "seg.mha")).data
    assert 0.05 < np.mean(ref == 1) < 0.95  # both labels present
    np.testing.assert_array_equal(got, ref)


def test_seg_convert_output_loads_in_both_packages(toolkit_model, tmp_path, capsys):
    d, tnet, _ = toolkit_model
    src = os.path.join(d, "ref")
    # the port's conversion, loaded by the JAX package
    out = convert_checkpoint(src, str(tmp_path / "port_conv"))
    assert out.endswith("chk_100") and "converted" in capsys.readouterr().out
    jm = jax_load_seg_model(str(tmp_path / "port_conv"))
    assert jm.epoch_idx == 100
    _forward_gap(lambda x: np.asarray(jm.net.apply(jm.variables, jnp.asarray(x),
                                                   train=False)), tnet)
    # the JAX package's conversion, loaded by the port
    jax_convert(src, str(tmp_path / "jax_conv"))
    pm = load_seg_model(str(tmp_path / "jax_conv"), torch.device("cpu"))

    def apply(x):
        with torch.no_grad():
            return pm.net(torch.from_numpy(x)).numpy()
    _forward_gap(apply, tnet)
    # a native input is re-saved as it is
    again = convert_checkpoint(str(tmp_path / "port_conv"), str(tmp_path / "again"))
    assert "already in native layout; re-saving" in capsys.readouterr().out
    a = torch.load(os.path.join(out, "params.pth"), weights_only=False)
    b = torch.load(os.path.join(again, "params.pth"), weights_only=False)
    assert a["_kernel_layouts"] == b["_kernel_layouts"]
    for k, t in a["state_dict"].items():
        assert torch.equal(t, b["state_dict"][k]), k


def test_seg_convert_requires_self_describing_payload(tmp_path):
    chk = tmp_path / "m" / "checkpoints" / "chk_1"
    chk.mkdir(parents=True)
    torch.save({"state_dict": {}, "net": "vnet"}, str(chk / "params.pth"))
    with pytest.raises(ValueError, match="missing 'in_channels'"):
        convert_checkpoint(str(tmp_path / "m"), str(tmp_path / "out"))
