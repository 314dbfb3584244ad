"""Port of window_conv_i8_pallas: the plain version (what the wrapper runs on
a CPU tensor) vs the JAX package's Pallas kernel in interpret mode, vs its
XLA reference ``reference_i8`` and vs the JAX int8 forward's residual-tail
formula.

The packed ``[B, D, H, cols, P*C]`` input of the JAX kernel is the same
memory as the port's NDHWC ``[B, D, H, cols*P, C]``; its inputs are built
with JAX's own ``window_kernels_np``/``mid9_np``/``halo9_np`` as
tests/test_pallas_i8win.py builds them. Both sides sum int8 products in
int32 (exact) and run the same float32 epilogue in the same order, so int8
outputs must be exactly equal; bf16 outputs within one bf16 step (measured:
exactly equal too).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation3d_tpu.models.packed_vnet import _act as jax_act
from segmentation3d_tpu.ops.packed_conv import window_kernels_np
from segmentation3d_tpu.ops.pallas_i8win import (
    halo9_np, mid9_np, reference_i8, window_conv_i8_pallas,
)
from segmentation3d_tpu.ops.quant import (
    quantize_weight_np as jax_quantize, requant as jax_requant,
    window_conv_packed_i8,
)
from segmentation3d_tpu_torch.ops import window_i8 as wi

INV = 127.0 / 8.0


def _setup(P, cin, cout, D=3, H=8, cols=6, seed=0, B=2):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.3, (3, 3, 3, cin, cout)).astype(np.float32)
    wq, ws = jax_quantize(w)
    x = rng.integers(-127, 128, (B, D, H, cols, P * cin)).astype(np.int8)
    s = (ws * np.float32(8.0 / 127.0)).astype(np.float32)
    b = rng.normal(0, 0.5, cout).astype(np.float32)
    return x, wq, s, b


def _port(x, wq, s, b, P, act, out, **kw):
    B, D, H, cols, pc = x.shape
    xt = torch.from_numpy(x.reshape(B, D, H, cols * P, pc // P))
    y = wi.window_conv_i8(xt, torch.from_numpy(wq), torch.from_numpy(s),
                          torch.from_numpy(b), act, 0.25, out=out,
                          inv_out=INV if out == "int8" else None, **kw)
    return y.to(torch.float32).numpy()


def _assert_match(got, ref, out):
    if out == "int8":
        np.testing.assert_array_equal(got, ref)
    else:  # one bf16 step
        np.testing.assert_allclose(got, ref, rtol=2.0 ** -8, atol=0)


@pytest.mark.parametrize("out", ["int8", "bf16"])
@pytest.mark.parametrize("act", ["relu", "prelu", "none"])
@pytest.mark.parametrize("P,cin", [(2, 8), (4, 4)])
def test_plain_matches_jax_pallas_kernel(P, cin, act, out):
    x, wq, s, b = _setup(P, cin, cin, seed=P * 10 + cin)
    mid, wl, wr = window_kernels_np(wq, P)
    pc = P * cin
    ref = np.asarray(window_conv_i8_pallas(
        jnp.asarray(x), jnp.asarray(mid9_np(mid)), jnp.asarray(halo9_np(wl)),
        jnp.asarray(halo9_np(wr)), jnp.asarray(np.tile(s, P)),
        jnp.asarray(np.tile(b, P)), jnp.asarray(np.full(pc, 0.25, np.float32)),
        P=P, cin=cin, cout=cin, act=act, inv_sa=INV, out_int8=out == "int8",
        interpret=True)).astype(np.float32)
    got = _port(x, wq, s, b, P, act, out).reshape(ref.shape)
    _assert_match(got, ref, out)


@pytest.mark.parametrize("act", ["relu", "prelu"])
@pytest.mark.parametrize("cin,cout,P", [(32, 2, 2), (4, 8, 4), (8, 16, 2)])
def test_plain_matches_reference_i8_channel_change(cin, cout, P, act):
    """cin != cout (the 32 -> 2 head), which the Pallas kernel refuses; its
    XLA reference takes it."""
    x, wq, s, b = _setup(P, cin, cout, D=3, H=5, cols=4, seed=cin + cout)
    mid, wl, wr = window_kernels_np(wq, P)
    ref = np.asarray(reference_i8(
        jnp.asarray(x), jnp.asarray(mid), jnp.asarray(wl), jnp.asarray(wr),
        jnp.asarray(np.tile(s, P)), jnp.asarray(np.tile(b, P)),
        jnp.float32(0.25), P=P, cin=cin, act=act, inv_sa=INV)).astype(np.float32)
    got = _port(x, wq, s, b, P, act, "int8").reshape(ref.shape)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("act", ["relu", "prelu"])
@pytest.mark.parametrize("same_input", [True, False])
def test_residual_tail_matches_jax_formula(act, same_input):
    """The fused tail ``requant(act(f32(id) * s_id + h))`` with ``h`` the
    conv's float32 activation, as models/packed_vnet.py:run_res computes it
    (exactly equal: XLA's CPU code does not contract the multiply-add here).
    ``same_input=False`` is a multi-conv chain's tail, whose identity is the
    block input and not the conv's."""
    P, c = 2, 8
    x, wq, s, b = _setup(P, c, c, seed=11)
    rng = np.random.default_rng(12)
    ident = x if same_input else rng.integers(-127, 128, x.shape).astype(np.int8)
    s_id = 6.0 / 127.0
    mid, wl, wr = window_kernels_np(wq, P)
    acc = window_conv_packed_i8(jnp.asarray(x), jnp.asarray(mid), jnp.asarray(wl),
                                jnp.asarray(wr), P=P, cin=c)
    h = jax_act(acc.astype(jnp.float32) * jnp.asarray(np.tile(s, P))
                + jnp.asarray(np.tile(b, P)), act, 0.2)
    a = jax_act(jnp.asarray(ident).astype(jnp.float32) * jnp.float32(s_id) + h,
                act, 0.3)
    ref = np.asarray(jax_requant(a, INV)).astype(np.float32)
    B, D, H, cols, pc = x.shape
    got = wi.window_conv_i8(
        torch.from_numpy(x.reshape(B, D, H, cols * P, c)), torch.from_numpy(wq),
        torch.from_numpy(s), torch.from_numpy(b), act, 0.2, out="int8",
        inv_out=INV, identity=torch.from_numpy(ident.reshape(B, D, H, cols * P, c)),
        s_id=s_id, res_act=act, res_alpha=0.3)
    np.testing.assert_array_equal(got.to(torch.float32).numpy().reshape(ref.shape), ref)


def test_wrapper_checks_its_inputs():
    x = torch.zeros(1, 2, 2, 2, 4, dtype=torch.int8)
    w = torch.zeros(3, 3, 3, 4, 8, dtype=torch.int8)
    s = b = torch.ones(8)
    with pytest.raises(ValueError, match="int8"):
        wi.window_conv_i8(x.float(), w, s, b, inv_out=1.0)
    with pytest.raises(ValueError, match="inv_out"):
        wi.window_conv_i8(x, w, s, b)
    with pytest.raises(ValueError, match="identity"):
        wi.window_conv_i8(x, w, s, b, inv_out=1.0, identity=x, s_id=1.0,
                          res_act="relu")
    with pytest.raises(ValueError, match="channels"):
        wi.window_conv_i8(x[..., :2], w, s, b, inv_out=1.0)
