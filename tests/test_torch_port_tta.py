"""Test-time flips and on-device Dice of the port's SlidingWindowInferer
against the JAX engine's, and seg_infer --tta against JAX's segmentation(tta=)
on the CPU, float32, the same weights.

With the flax forward inside both engines the flip logic alone is under
test: masks identical, probabilities within 1e-4, Dice equal. End to end,
the masks follow tests/test_torch_port_seg_infer.py's rule and the
probability maps agree within 2e-3.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phantoms import make_sphere_case
from segmentation3d_tpu.core import infer_engine as je
from segmentation3d_tpu.core.seg_infer import segmentation as jax_segmentation
from segmentation3d_tpu.io import read_image as jax_read
from segmentation3d_tpu_torch.cli.seg_infer import main as seg_infer
from segmentation3d_tpu_torch.core import infer_engine as te
from segmentation3d_tpu_torch.core.seg_infer import module_forward
from test_torch_port_checkpoint import jax_net, seeded_variables
from test_torch_port_infer_engine import phantom
from test_torch_port_pipeline import assert_same_mask, save_model

# every spec of tests/test_infer_engine.py::test_tta_axes_normalization
SPECS = [None, "", "none", "all", "x,z", ["X", "y"], "x", "zyx"]


@pytest.mark.parametrize("spec", SPECS, ids=repr)
def test_tta_axes_and_combos_match_jax(spec):
    assert te.tta_axes(spec) == je.tta_axes(spec)
    assert te.tta_flip_combos(spec) == je.tta_flip_combos(spec)


def test_bad_tta_axis_raises_jax_error():
    with pytest.raises(ValueError) as ref:
        je.tta_axes("q")
    with pytest.raises(ValueError) as got:
        te.tta_axes("q")
    assert str(got.value) == str(ref.value)


@pytest.fixture(scope="module")
def nets():
    v, net = seeded_variables(seed=3)
    return jax_net(), v, net


def flax_forward(jnet, v):
    apply = jax.jit(lambda x: jnet.apply(v, x, train=False))

    def forward(p):
        return torch.from_numpy(np.array(apply(jnp.asarray(p.numpy()))))
    return forward


@pytest.mark.parametrize("tta", ["x", "all"])
def test_flip_average_matches_jax_engine(nets, tta):
    jnet, v, net = nets
    vol = phantom()
    patch, stride = (16, 16, 16), (8, 8, 8)
    jinf = je.SlidingWindowInferer(jnet, patch, 2, batch_size=4, tta=tta)
    tinf = te.SlidingWindowInferer(flax_forward(jnet, v), patch, 2,
                                   batch_size=4, tta=tta)
    jmask, jprob = jinf(v, jnp.asarray(vol), stride_zyx=stride, return_prob=True)
    tmask, tprob = tinf(torch.from_numpy(vol), stride_zyx=stride, return_prob=True)
    np.testing.assert_allclose(tprob.numpy(), np.asarray(jprob), atol=1e-4)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    # the flips change the result: the average is not a no-op here
    plain = te.SlidingWindowInferer(flax_forward(jnet, v), patch, 2, batch_size=4)
    assert not torch.allclose(plain(torch.from_numpy(vol), stride_zyx=stride,
                                    return_prob=True)[1], tprob, atol=1e-3)


@pytest.mark.parametrize("own_forward", [False, True])
def test_dice_matches_jax(nets, own_forward):
    jnet, v, net = nets
    vol = phantom()
    gt = (vol[..., 0] > 0).astype(np.uint8)
    valid = (30, 29, 31)
    jinf = je.SlidingWindowInferer(jnet, (16, 16, 16), 2, batch_size=3)
    fwd = module_forward(net, torch.float32) if own_forward \
        else flax_forward(jnet, v)
    tinf = te.SlidingWindowInferer(fwd, (16, 16, 16), 2, batch_size=3)
    ref = jinf.dice(v, jnp.asarray(vol), jnp.asarray(gt), valid, stride_zyx=(8, 8, 8))
    got = tinf.dice(torch.from_numpy(vol), torch.from_numpy(gt), valid,
                    stride_zyx=(8, 8, 8))
    assert got.dtype == np.float32 and got.shape == ref.shape == (1,)
    assert 0.05 < float(ref[0]) < 0.99
    if own_forward:  # masks may differ at argmax near-ties
        np.testing.assert_allclose(got, ref, atol=1e-3)
    else:
        np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tta"))
    imgs, _ = make_sphere_case(d, "case", shape_zyx=(30, 34, 28),
                               spacing=(1.1, 0.9, 1.3))
    model = save_model(os.path.join(d, "model"), seed=4)
    seg_infer(["-i", imgs[0], "-m", model, "-o", os.path.join(d, "plain"),
               "-g", "-1", "--save_prob"])
    return d, imgs[0], model


@pytest.mark.parametrize("tta", ["x", "all"])
def test_cli_tta_matches_jax_segmentation(case, tta):
    d, img, model = case
    jax_segmentation(img, model, os.path.join(d, "jax_" + tta), tta=tta,
                     save_prob=True)
    res = seg_infer(["-i", img, "-m", model, "-o", os.path.join(d, "port_" + tta),
                     "-g", "-1", "--save_prob", "--tta", tta])
    assert [r[0] for r in res] == ["case_mod0"]
    # the flip average of this seeded net labels nearly every voxel of the
    # case as foreground, so the probability maps carry the comparison
    assert_same_mask(os.path.join(d, "port_" + tta), os.path.join(d, "jax_" + tta),
                     both_labels=False)
    p1 = jax_read(os.path.join(d, "jax_" + tta, "case_mod0", "prob_1.mha")).data
    plain = jax_read(os.path.join(d, "plain", "case_mod0", "prob_1.mha")).data
    assert np.ptp(p1) > 0.1 and np.abs(p1 - plain).max() > 0.1
