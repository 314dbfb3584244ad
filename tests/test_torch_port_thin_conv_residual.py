"""Port of thin_conv3d vs the JAX Pallas kernel (interpret mode), on the
cin == cout site with every residual tail. Tolerances as in
test_torch_port_thin_conv.py (both sides round operands to bf16)."""
import pytest

from test_torch_port_thin_conv import ACTS, OUTS, assert_close, inputs, run_both


@pytest.mark.parametrize("out", OUTS)
@pytest.mark.parametrize("residual", ACTS)
@pytest.mark.parametrize("act", ACTS)
def test_matches_jax_kernel_32ch(act, residual, out):
    x, w, b = inputs(32, 32, seed=32)
    ref, got = run_both(x, w, b, act, residual, out)
    assert_close(got, ref, out)
