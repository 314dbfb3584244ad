"""Port of ops/quant.py: weight quantization, requant rounding and the
int8 GEMM forms of the 2^3/s2 down conv and deconv, against the JAX
package's functions on the same seeded inputs. All of it is integer
arithmetic or a copy of numpy code, so every comparison is exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation3d_tpu.ops.packed_conv import (
    deconv_gemm_np, deconv_unshuffle, down_kernel_np,
)
from segmentation3d_tpu.ops.quant import (
    conv_i8, deconv_gemm_apply_i8, down_conv_packed_i8,
    quantize_weight_np as jax_quantize, requant as jax_requant,
)
from segmentation3d_tpu_torch.ops import quant as q

_DN = ("NDHWC", "DHWIO", "NDHWC")


def test_quantize_weight_matches_jax():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 3, 3, 8, 16)).astype(np.float32) * 0.3
    w[..., 3] = 0.0  # an all-zero output channel
    w[0, 0, 0, 0, 5] = 0.5 * np.abs(w[..., 5]).max() / 127 * 127  # a tie
    wq, s = q.quantize_weight_np(w)
    wq_j, s_j = jax_quantize(w)
    assert wq.dtype == np.int8 and s.dtype == np.float32
    np.testing.assert_array_equal(wq, wq_j)
    np.testing.assert_array_equal(s, s_j)


def test_requant_rounds_half_to_even():
    a = torch.tensor([0.5, 1.5, -2.5, 2.5, -0.5, 200.0, -300.0, 0.49])
    got = q.requant(a, 1.0)
    assert got.dtype == torch.int8
    assert got.tolist() == [0, 2, -2, 2, 0, 127, -127, 0]
    ref = np.asarray(jax_requant(jnp.asarray(a.numpy()), 1.0))
    np.testing.assert_array_equal(got.numpy(), ref)


def _ints(shape, seed, lo=-127, hi=128):
    return np.random.default_rng(seed).integers(lo, hi, size=shape).astype(np.int8)


@pytest.mark.parametrize("P", [2, 4])
def test_down_conv_i8_matches_jax(P):
    cin, cout, W = 4, 8, 16
    x = _ints((2, 4, 6, W, cin), 1)
    w = _ints((2, 2, 2, cin, cout), 2)
    got = q.down_conv_i8(torch.from_numpy(x), torch.from_numpy(q.down_weight(w)))
    assert got.dtype == torch.int32 and got.shape == (2, 2, 3, W // 2, cout)
    ref = np.asarray(conv_i8(jnp.asarray(x), jnp.asarray(w), (2, 2, 2),
                             ((0, 0), (0, 0), (0, 0))))
    np.testing.assert_array_equal(got.numpy(), ref)
    packed = down_conv_packed_i8(jnp.asarray(x).reshape(2, 4, 6, W // P, P * cin),
                                 jnp.asarray(down_kernel_np(w, P)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(packed).reshape(ref.shape))


@pytest.mark.parametrize("P", [2, 4])
def test_deconv_i8_matches_jax(P):
    """The port's weight gives output voxel 2z+dz the product x[z] @ w[dz]
    (torch's transposed-conv convention); flax's kernel is its flip."""
    cin, cout, W = 8, 4, 8
    x = _ints((1, 3, 4, W, cin), 3)
    wu = _ints((2, 2, 2, cin, cout), 4)  # flax layout
    got = q.deconv_i8(torch.from_numpy(x),
                      torch.from_numpy(q.deconv_weight(wu[::-1, ::-1, ::-1])))
    assert got.dtype == torch.int32 and got.shape == (1, 6, 8, 2 * W, cout)
    y = deconv_gemm_apply_i8(jnp.asarray(x).reshape(1, 3, 4, W // P, P * cin),
                             jnp.asarray(deconv_gemm_np(wu, P)))
    y = deconv_unshuffle(y.reshape(1, 3, 4, W // P, 2, 2, 2 * P * cout))
    np.testing.assert_array_equal(got.numpy(), np.asarray(y).reshape(got.shape))
    ref = jax.lax.conv_transpose(jnp.asarray(x, jnp.float32),
                                 jnp.asarray(wu, jnp.float32), (2, 2, 2),
                                 "VALID", dimension_numbers=_DN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref, np.int64))


def test_deconv_epilogue_runs_before_the_shuffle():
    """The epilogue sees the GEMM output per (dz, dy, dx, cout); applying it
    before the depth-to-space equals applying it after."""
    x = _ints((1, 2, 2, 2, 8), 5)
    w = torch.from_numpy(q.deconv_weight(_ints((2, 2, 2, 8, 8), 6)))
    s = torch.linspace(0.01, 0.02, 8)
    b = torch.linspace(-0.5, 0.5, 8)

    def epi(y):
        return q.dequant_act_requant(y, s, b, "relu", 0.25, 1.0)
    before = q.deconv_i8(torch.from_numpy(x), w, epi)
    after = epi(q.deconv_i8(torch.from_numpy(x), w))
    assert torch.equal(before, after) and before.dtype == torch.int8


def test_int_mm_pads_small_m_and_refuses_odd_k_n():
    a = torch.from_numpy(_ints((3, 16), 7))
    w = torch.from_numpy(_ints((8, 16), 8))
    got = q.int_mm(a, w)
    assert got.shape == (3, 8)
    assert torch.equal(got, (a.long() @ w.long().T).to(torch.int32))
    with pytest.raises(ValueError, match="multiples of 8"):
        q.int_mm(a[:, :12], w[:, :12])
    with pytest.raises(ValueError, match="multiples of 8"):
        q.int_mm(a, w[:6])
