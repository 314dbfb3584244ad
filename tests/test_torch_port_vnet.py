"""The port's V-Net module and folded kernel forward vs the flax V-Net and
JAX's build_fused_forward (Pallas routing on, interpret mode).

Bars: the module in float32 within 1e-4 of flax. The folded forward in
float32 rounds every conv's operands to bf16, as the JAX fused forward
does; tests/test_pallas_conv.py holds that one within atol 0.02 of flax on
flax's init, but on these seeded nets (non-trivial BatchNorm) the JAX
fused forward itself strays up to ~0.03. So the port must stay within
max(0.02, 1.5 x the JAX fused forward's own error) of flax, within 0.05 of
the JAX fused forward (the two round at different sites: JAX's falls back
to float32 XLA convs below 8 voxels of width), with argmax agreement
> 0.99; in bf16, argmax agreement > 0.98 against flax float32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation3d_tpu.models.fused_vnet import build_fused_forward as jax_fused
from segmentation3d_tpu_torch.models.fused_vnet import build_fused_forward
from segmentation3d_tpu_torch.ops import thin_conv as tc
from test_torch_port_checkpoint import jax_net, seeded_variables


def nets(act, in_ch, seed=0):
    v, net = seeded_variables(act, in_ch, seed=seed)
    x = np.random.default_rng(seed).normal(
        size=(2, 16, 16, 16, in_ch)).astype(np.float32)
    return jax_net(act, in_ch), v, net, x


CASES = [("relu", 1), ("prelu", 1), ("relu", 4)]


@pytest.mark.parametrize("act,in_ch", CASES)
def test_module_matches_flax(act, in_ch):
    jnet, v, net, x = nets(act, in_ch)
    ref = np.asarray(jnet.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4)


@pytest.mark.parametrize("act,in_ch", CASES)
def test_folded_forward_f32_matches_jax_fused(act, in_ch):
    jnet, v, net, x = nets(act, in_ch, seed=1)
    flax_out = np.asarray(jnet.apply(v, jnp.asarray(x), train=False))
    fn, fv = jax_fused(jnet, v, dtype=jnp.float32, use_pallas=True,
                       interpret=True)
    jax_out = np.asarray(fn(fv, jnp.asarray(x)))
    before = tc.thin_conv3d.launches
    got = build_fused_forward(net, dtype=torch.float32)(torch.from_numpy(x)).numpy()
    assert tc.thin_conv3d.launches == before  # CPU tensors: plain version
    jax_err = float(np.abs(jax_out - flax_out).max())
    np.testing.assert_allclose(got, flax_out, atol=max(0.02, 1.5 * jax_err))
    np.testing.assert_allclose(got, jax_out, atol=0.05)
    agree = np.mean(np.argmax(got, -1) == np.argmax(flax_out, -1))
    assert agree > 0.99


@pytest.mark.parametrize("act,in_ch", CASES)
def test_folded_forward_bf16_argmax(act, in_ch):
    jnet, v, net, x = nets(act, in_ch, seed=2)
    flax_out = np.asarray(jnet.apply(v, jnp.asarray(x), train=False))
    got = build_fused_forward(net, dtype=torch.bfloat16)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == flax_out.shape
    agree = np.mean(np.argmax(got.numpy(), -1) == np.argmax(flax_out, -1))
    assert agree > 0.98


def test_folded_forward_site_count():
    """Every stride-1 3^3 conv goes through thin_conv3d: stem, residual
    convs (1+2 down, 2+1 up) and head = 8 calls for this net."""
    _, _, net, x = nets("relu", 1)
    calls = []
    real = tc.thin_conv3d
    import segmentation3d_tpu_torch.models.fused_vnet as fv_mod

    def spy(*a, **k):
        calls.append((tuple(a[1].shape), k.get("residual", "none")))
        return real(*a, **k)
    fv_mod.thin_conv3d = spy
    try:
        build_fused_forward(net, dtype=torch.bfloat16)(torch.from_numpy(x))
    finally:
        fv_mod.thin_conv3d = real
    assert len(calls) == 8
    assert calls[0][0] == (3, 3, 3, 1, 4) and calls[-1][0] == (3, 3, 3, 8, 2)
    # single-conv residual blocks fuse their tail into the kernel
    assert [r for _, r in calls].count("relu") == 2
