"""The port's int8 forward (models/quant_vnet.py) vs the JAX package's
``build_packed_forward(quant="int8")`` and ``calibrate_int8``, on the CPU.

- Bookkeeping, exact: every site's int8 weights (packed with JAX's own
  packers), dequant vector, bias, ``1/s_out``, ``s_id`` and slopes equal the
  JAX build's, uncalibrated and calibrated. This pins the site graph and the
  unification of concat partners.
- Everything after the stem is exact: with the stem computed from float32
  operands, as the JAX float32 build computes it, the port's probabilities
  equal the JAX float32 build's to float32 rounding (measured max |dprob|
  below 1e-6, every argmax equal).
- As shipped, the port's stem rounds its operands to bf16 (the kernel's
  operand type) and requantizes from a float32 sum; the JAX float32 build
  does not round, and its bf16 build rounds the stem output to bf16 before
  the requant. So a few percent of the stem's int8 outputs differ by one
  step, and the int8 noise downstream carries that into the probabilities.
  On test_quant.py's own setting (flax init, full width, seed 0, a
  1x16x16x32 patch) the measured gaps are max |dprob| 0.025-0.038 and
  argmax agreement 0.983-0.991 over the eight (act, dtype, calib) cases,
  the same size as the JAX int8 build's own gap to flax there (0.029-0.044).
  Twice the gap exceeds test_quant.py's bar, so its bars hold: |dprob| <=
  0.06 and agreement >= 0.98. (Seeds 1 and 2 give gaps up to 0.087, again
  with the JAX int8 build as far from flax: the gap is the int8 noise level,
  not a fault of either side.)
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from segmentation3d_tpu.models.packed_vnet import (
    build_packed_forward, calibrate_int8 as jax_calibrate,
)
from segmentation3d_tpu.models.vnet import SegmentationNet as JaxNet
from segmentation3d_tpu.ops.packed_conv import (
    deconv_gemm_np, down_kernel_np, window_kernels_np,
)
from segmentation3d_tpu_torch.models import quant_vnet as qv
from segmentation3d_tpu_torch.models.vnet import SegmentationNet
from segmentation3d_tpu_torch.ops.quant import requant
from segmentation3d_tpu_torch.ops.thin_conv import activation
from segmentation3d_tpu_torch.utils import model_io
from test_torch_port_checkpoint import jax_net, seeded_variables

ACTS = ["relu", "prelu"]


@pytest.fixture(scope="module")
def seeded():
    """{act: (flax variables, port net, x, JAX calibration dict)} for the
    small seeded nets of test_torch_port_checkpoint."""
    out = {}
    for act in ACTS:
        v, net = seeded_variables(act, seed=3)
        x = np.random.default_rng(0).normal(size=(2, 16, 16, 32, 1)).astype(np.float32)
        calib = jax_calibrate(jax_net(act), v, [jnp.asarray(x)], dtype=jnp.float32)
        out[act] = (v, net, x, calib)
    return out


def _jax_meta(apply_fn):
    """The JAX build's per-site static info (its ``meta`` closure)."""
    cells = dict(zip(apply_fn.__code__.co_freevars, apply_fn.__closure__))
    return cells["meta"].cell_contents


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("act", ACTS)
def test_site_bookkeeping_matches_jax(seeded, act, calibrated):
    v, net, _, calib = seeded[act]
    calib = calib if calibrated else None
    fn, fv = build_packed_forward(jax_net(act), v, dtype=jnp.float32,
                                  quant="int8", calib=calib)
    meta = _jax_meta(fn)
    sites = qv.build_int8_forward(net, calib=calib, dtype=torch.float32).sites
    assert set(sites) == set(meta) - {"out_block"}
    for key, s in sites.items():
        m = meta[key]
        assert s["inv_out"] == m["inv_out"], key
        if "n" in s:  # residual block: the tail's scales and slope
            assert s["s_id"] == m["s_id"] and s["alpha_out"] == m["alpha_out"], key
            continue
        assert s["alpha"] == m["alpha"], key
        if key == "in_block/conv":
            continue
        j = fv[key]
        wq = s["w_dhwio"]
        cout = wq.shape[-1]
        np.testing.assert_array_equal(s["s"].numpy(), j["s"][:cout], err_msg=key)
        np.testing.assert_array_equal(s["b"].numpy(), j["b"][:cout], err_msg=key)
        if key.endswith("/up"):
            np.testing.assert_array_equal(
                deconv_gemm_np(wq[::-1, ::-1, ::-1], m["P"]), j["k"], err_msg=key)
        elif key.endswith("/down"):
            np.testing.assert_array_equal(
                down_kernel_np(wq, m["P"]) if m["route"] == "packed" else wq,
                j.get("k", j.get("w")), err_msg=key)
        elif m["P"] > 1:
            for got, ref in zip(window_kernels_np(wq, m["P"]),
                                (j["mid"], j["left"], j["right"])):
                np.testing.assert_array_equal(got, ref, err_msg=key)
        else:
            np.testing.assert_array_equal(wq, j["w"], err_msg=key)


def _f32_stem(x, w, b, act, alpha, quant_inv_sa):
    """The stem as the JAX float32 build computes it: float32 operands (no
    bf16 rounding), then bias, act and requant in float32."""
    acc = F.conv3d(x.double().permute(0, 4, 1, 2, 3),
                   w.double().permute(4, 3, 0, 1, 2), padding=1)
    a = acc.permute(0, 2, 3, 4, 1).to(torch.float32) + b
    return requant(activation(a, act, alpha), quant_inv_sa)


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("act", ACTS)
def test_exact_after_the_stem(seeded, act, calibrated, monkeypatch):
    v, net, x, calib = seeded[act]
    calib = calib if calibrated else None
    fn, fv = build_packed_forward(jax_net(act), v, dtype=jnp.float32,
                                  quant="int8", calib=calib)
    ref = np.asarray(fn(fv, jnp.asarray(x)))
    monkeypatch.setattr(qv, "thin_conv3d", _f32_stem)
    got = qv.build_int8_forward(net, calib=calib, dtype=torch.float32)(
        torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


@pytest.fixture(scope="module")
def flax_init_nets():
    """test_quant.py's setting: full-width V-Nets at flax's own init
    (PRNGKey(0)), a 1x16x16x32 normal patch, and the port's net holding
    the same weights."""
    out = {}
    x = np.random.default_rng(0).normal(size=(1, 16, 16, 32, 1)).astype(np.float32)
    for act in ACTS:
        jnet = JaxNet(in_channels=1, out_channels=2, act=act)
        v = jax.tree_util.tree_map(np.asarray, jax.jit(
            lambda k, a: jnet.init(k, a, train=False))(jax.random.PRNGKey(0),
                                                       jnp.asarray(x)))
        net = SegmentationNet(1, 2, act=act)
        net.load_state_dict({k: torch.as_tensor(np.asarray(a)) for k, a in
                             model_io.params_from_jax(v).items()}, strict=True)
        out[act] = (jnet, v, net.eval())
    return x, out


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("act", ACTS)
def test_forward_matches_jax_int8(flax_init_nets, act, calibrated):
    x, nets = flax_init_nets
    jnet, v, net = nets[act]
    calib = jax_calibrate(jnet, v, [jnp.asarray(x)], dtype=jnp.float32) \
        if calibrated else None
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        fn, fv = build_packed_forward(jnet, v, dtype=jdt, quant="int8", calib=calib)
        ref = np.asarray(fn(fv, jnp.asarray(x)))
        got = qv.build_int8_forward(net, calib=calib, dtype=tdt)(
            torch.from_numpy(x)).numpy()
        assert got.shape == ref.shape and got.dtype == np.float32
        assert np.abs(got - ref).max() <= 0.06, (jdt, np.abs(got - ref).max())
        assert np.mean(got.argmax(-1) == ref.argmax(-1)) >= 0.98


@pytest.mark.parametrize("act", ACTS)
def test_calibration_matches_jax(seeded, act):
    """Same site keys; maxima within 1% (measured 0.4%: the port's
    full-precision forward rounds conv operands to bf16, JAX's float32
    packed forward does not)."""
    v, net, x, calib = seeded[act]
    got = qv.calibrate_int8(net, [torch.from_numpy(x)], dtype=torch.float32)
    assert set(got) == set(calib)
    assert all(isinstance(a, float) and a > 0 for a in got.values())
    for k in calib:
        assert abs(got[k] / calib[k] - 1) <= 0.01, (k, got[k], calib[k])


def test_constant_calibration_reproduces_act_clip(seeded):
    """test_quant.py:test_calibrated_quant's exactness property: a
    constant-8.0 dict at margin 1.0 gives the uncalibrated act_clip=8 forward
    bit for bit; a dict missing a site raises."""
    v, net, x, calib = seeded["relu"]
    xt = torch.from_numpy(x)
    plain = qv.build_int8_forward(net, act_clip=8.0)(xt)
    const = qv.build_int8_forward(net, calib={k: 8.0 for k in calib},
                                  calib_margin=1.0)(xt)
    assert torch.equal(plain, const)
    bad = dict(calib)
    bad.pop("in_block/conv")
    with pytest.raises(ValueError, match="missing activation site"):
        qv.build_int8_forward(net, calib=bad)


def test_site_graph_unifies_concat_partners(seeded):
    _, net, _, _ = seeded["relu"]
    sites_in, pairs = qv.site_graph(net)
    assert pairs == [("up_16/up", "down_8/res"), ("up_8/up", "in_block/conv")]
    s = qv.site_scales(net, calib={k: float(i + 1) for i, k in enumerate(sites_in)},
                       calib_margin=1.0)
    for uk, sk in pairs:
        assert s[uk] == s[sk]
    assert sites_in["down_16/res"] == "down_16/down"
    assert sites_in["out_block/conv"] == "up_8/res"
