"""Port of thin_conv3d vs the JAX Pallas kernel (interpret mode), thin sites.

Both sides round x and w to bf16 and accumulate in float32, so they differ
only by the order of the float32 sums (~1e-6 relative). Tolerances:
float32 out rtol/atol 2e-5 x max|ref|; bf16 out one bf16 step (at most
2^-7 relative) where the two float32 sums straddle a rounding boundary; int8 out
at most one step where ``acc * inv_sa`` lands that close to a half.
The residual tail needs cin == cout, so its cases are the (32, 32) site
of test_torch_port_thin_conv_residual.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation3d_tpu.ops import pallas_conv as jpc
from segmentation3d_tpu_torch.ops import thin_conv as tc

ACTS = ["none", "relu", "prelu"]
OUTS = ["bf16", "f32", "int8"]
_JDT = {"bf16": jnp.bfloat16, "f32": jnp.float32, "int8": jnp.int8}
_TDT = {"bf16": torch.bfloat16, "f32": torch.float32, "int8": torch.int8}
INV_SA = 20.0


def inputs(cin, cout, seed, shape=(1, 4, 6, 16)):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape + (cin,)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, cin, cout)) * (2.0 / (27 * cin)) ** 0.5
         ).astype(np.float32)
    b = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    return x, w, b


def run_both(x, w, b, act, residual, out):
    q = INV_SA if out == "int8" else None
    ref = jpc.thin_conv3d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                          act=act, alpha=0.1, out_dtype=_JDT[out],
                          interpret=True, residual=residual, res_alpha=0.2,
                          quant_inv_sa=q)
    got = tc.thin_conv3d(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b), act=act, alpha=0.1,
                         out_dtype=_TDT[out], residual=residual,
                         res_alpha=0.2, quant_inv_sa=q)
    assert got.dtype == _TDT[out]
    return np.asarray(ref).astype(np.float32), got.to(torch.float32).numpy()


def assert_close(got, ref, out):
    assert got.shape == ref.shape
    scale = float(np.abs(ref).max())
    if out == "f32":
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5 * scale)
    elif out == "bf16":
        np.testing.assert_allclose(got, ref, rtol=2.0 ** -7, atol=1e-6 * scale)
    else:
        assert np.abs(got - ref).max() <= 1.0
        assert np.mean(got == ref) > 0.99


@pytest.mark.parametrize("out", OUTS)
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("cin,cout", [(1, 16), (4, 16), (32, 2)])
def test_matches_jax_kernel(cin, cout, act, out):
    x, w, b = inputs(cin, cout, seed=cin * 100 + cout)
    ref, got = run_both(x, w, b, act, "none", out)
    assert_close(got, ref, out)


def test_plain_matches_jax_reference_on_bf16_values():
    """On bf16-representable inputs the plain version IS the JAX package's
    float32 reference (no operand rounding left to differ)."""
    x, w, b = inputs(32, 32, seed=7)
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    w = np.asarray(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32))
    ref = np.asarray(jpc.thin_conv3d_reference(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), "prelu", alpha=0.1,
        residual="relu", res_alpha=0.2))
    got = tc.thin_conv3d_reference(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        act="prelu", alpha=0.1, out_dtype=torch.float32, residual="relu",
        res_alpha=0.2).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_fold_bn_matches_jax():
    rng = np.random.default_rng(3)
    w = rng.normal(size=(3, 3, 3, 4, 8)).astype(np.float32)
    args = [rng.normal(size=8).astype(np.float32) for _ in range(4)]
    args[3] = np.abs(args[3]) + 0.5  # var
    w_j, b_j = jpc.fold_bn_np(w, args[0], args[1], args[2], args[0], args[3])
    w_t, b_t = tc.fold_bn_np(w, args[0], args[1], args[2], args[0], args[3])
    np.testing.assert_array_equal(w_t, w_j)
    np.testing.assert_array_equal(b_t, b_j)


def test_rejects_residual_with_channel_change():
    x = torch.zeros(1, 4, 4, 4, 8)
    w = torch.zeros(3, 3, 3, 8, 16)
    with pytest.raises(ValueError, match="cin == cout"):
        tc.thin_conv3d(x, w, residual="relu")
