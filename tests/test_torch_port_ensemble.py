"""Ensembles (several model directories) in the port against the JAX
package's segmentation([...]) on the CPU, float32: the class probabilities
averaged on the device before the argmax, the preprocessing contract
checked with JAX's message, and the CLI's repeated -m. Masks by
tests/test_torch_port_seg_infer.py's rule, probability maps within 2e-3.
"""
import os

import numpy as np
import pytest
import torch

from phantoms import make_sphere_case
from segmentation3d_tpu.core.seg_infer import segmentation as jax_segmentation
from segmentation3d_tpu.io import read_image as jax_read
from segmentation3d_tpu_torch.cli.seg_infer import main as seg_infer
from segmentation3d_tpu_torch.core import infer_engine as te
from segmentation3d_tpu_torch.core.seg_infer import (
    ensemble_forward, module_forward, segmentation,
)
from test_torch_port_checkpoint import seeded_variables
from test_torch_port_infer_engine import phantom
from test_torch_port_pipeline import assert_same_mask, save_model


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ens"))
    imgs, _ = make_sphere_case(d, "case", shape_zyx=(30, 34, 28),
                               spacing=(1.1, 0.9, 1.3))
    a = save_model(os.path.join(d, "a"), seed=4)
    b = save_model(os.path.join(d, "b"), seed=13)
    return d, imgs[0], a, b


def test_ensemble_matches_jax(case):
    d, img, a, b = case
    jax_segmentation(img, [a, b], os.path.join(d, "jax"), save_prob=True)
    res = segmentation(img, [a, b], os.path.join(d, "port"), device="cpu",
                       save_prob=True)
    assert [r[0] for r in res] == ["case_mod0"]
    assert_same_mask(os.path.join(d, "port"), os.path.join(d, "jax"))
    # the members disagree: the mean is neither of them
    for m in (a, b):
        segmentation(img, m, os.path.join(d, "one_" + os.path.basename(m)),
                     device="cpu", save_prob=True)
    p = [jax_read(os.path.join(d, r, "case_mod0", "prob_1.mha")).data
         for r in ("port", "one_a", "one_b")]
    assert np.abs(p[1] - p[2]).max() > 0.1
    np.testing.assert_allclose(p[0], (p[1] + p[2]) / 2, atol=2.0 ** -10)


def test_ensemble_forward_is_the_mean_of_its_members():
    vol = torch.from_numpy(phantom())
    infs = [te.SlidingWindowInferer(module_forward(seeded_variables(seed=s)[1],
                                                   torch.float32),
                                    (16, 16, 16), 2, batch_size=4)
            for s in (1, 2, 3)]
    mask, prob = ensemble_forward(infs, vol, stride_zyx=(8, 8, 8))
    members = [inf(vol, stride_zyx=(8, 8, 8), return_prob=True)[1] for inf in infs]
    assert torch.equal(prob, (members[0] + members[1] + members[2]) / 3.0)
    assert torch.equal(mask, torch.argmax(prob, dim=-1).to(torch.uint8))
    one_mask, one_prob = ensemble_forward(infs[:1], vol, stride_zyx=(8, 8, 8))
    assert torch.equal(one_prob, members[0])


def test_contract_mismatch_raises_jax_message(case, tmp_path):
    d, img, a, _ = case
    c = save_model(tmp_path / "c", seed=5, spacing=(2.0, 2.0, 2.0))
    with pytest.raises(ValueError) as ref:
        jax_segmentation(img, [a, c], str(tmp_path / "jax"))
    with pytest.raises(ValueError) as got:
        segmentation(img, [a, c], str(tmp_path / "port"), device="cpu")
    assert "preprocessing contract" in str(ref.value)
    assert str(got.value) == str(ref.value)
    with pytest.raises(ValueError, match="at least one"):
        segmentation(img, [], str(tmp_path / "none"), device="cpu")


def test_cli_accepts_repeated_model(case):
    """``-m a -m b`` is the ensemble; ``-m a -m a`` is exactly ``-m a``."""
    d, img, a, b = case
    base = ["-i", img, "-g", "-1"]
    seg_infer(base + ["-m", a, "-m", b, "-o", os.path.join(d, "cli_ab")])
    seg_infer(base + ["-m", a, "-m", a, "-o", os.path.join(d, "cli_aa")])
    seg_infer(base + ["-m", a, "-o", os.path.join(d, "cli_a")])
    segmentation(img, [a, b], os.path.join(d, "api_ab"), device="cpu")

    def mask(r):
        return jax_read(os.path.join(d, r, "case_mod0", "seg.mha")).data
    np.testing.assert_array_equal(mask("cli_ab"), mask("api_ab"))
    np.testing.assert_array_equal(mask("cli_aa"), mask("cli_a"))
