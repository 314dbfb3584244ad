"""Patch-sharded sliding-window inference: the port's SlidingWindowInferer
over several shards (every shard on the CPU) against its unsharded run and
against the JAX engine on a mesh of the 8 virtual CPU devices.

Sharding splits the box batches and adds the shards' accumulators in shard
order, so it only reassociates float32 sums: probabilities within 1e-5
(JAX's bar for its sharded engines, tests/test_spatial_shard.py), masks
equal. Against JAX the forward is a blur written in both frameworks, so the
engines alone are compared.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation3d_tpu.core import infer_engine as je
from segmentation3d_tpu.parallel import make_mesh
from segmentation3d_tpu_torch.core import infer_engine as te
from segmentation3d_tpu_torch.core.seg_infer import ensemble_forward, module_forward
from segmentation3d_tpu_torch.models.fused_vnet import build_fused_forward
from segmentation3d_tpu_torch.models.quant_vnet import build_int8_forward
from segmentation3d_tpu_torch.models.vnet import SegmentationNet

PATCH, STRIDE = (8, 8, 8), (4, 4, 4)
SHARDS = [1, 2, 3, 8]


class _BlurNet:
    """A net with a spatial receptive field and no symmetry in z or x: the
    class-1 probability is a weighted 3-voxel z-average of a squashed input
    plus an x ramp, so a mis-pasted or mis-flipped patch shows."""

    def apply(self, variables, x, train=False):
        v = x[..., :1]
        b = (jnp.roll(v, 1, axis=1) + 2 * v + jnp.roll(v, -1, axis=1)) / 4.0
        ramp = jnp.linspace(0.0, 0.2, x.shape[3]).reshape(1, 1, 1, -1, 1)
        p = jnp.clip(b + ramp, 0.0, 1.0)
        return jnp.concatenate([1.0 - p, p], axis=-1)


def blur(x):
    v = x[..., :1]
    b = (torch.roll(v, 1, 1) + 2 * v + torch.roll(v, -1, 1)) / 4.0
    ramp = torch.linspace(0.0, 0.2, x.shape[3]).reshape(1, 1, 1, -1, 1)
    p = torch.clamp(b + ramp, 0.0, 1.0)
    return torch.cat([1.0 - p, p], -1)


def _vol(shape=(20, 16, 24), seed=0):
    return np.random.default_rng(seed).uniform(0.2, 0.8, shape + (1,)).astype(np.float32)


def _shards(n):
    return [torch.device("cpu")] * n


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("tta", [None, "zx"])
def test_matches_unsharded_and_jax_mesh(n, tta):
    vol = _vol()
    kw = dict(batch_size=3, blend="gaussian", tta=tta)
    ref_m, ref_p = te.SlidingWindowInferer(blur, PATCH, 2, **kw)(
        torch.from_numpy(vol), stride_zyx=STRIDE, return_prob=True)
    m, p = te.SlidingWindowInferer(blur, PATCH, 2, devices=_shards(n), **kw)(
        torch.from_numpy(vol), stride_zyx=STRIDE, return_prob=True)
    np.testing.assert_allclose(p.numpy(), ref_p.numpy(), atol=1e-5)
    np.testing.assert_array_equal(m.numpy(), ref_m.numpy())
    jinf = je.SlidingWindowInferer(_BlurNet(), PATCH, 2, mesh=make_mesh(n), **kw)
    jm, jp = jinf(None, jnp.asarray(vol), stride_zyx=STRIDE, return_prob=True)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=1e-5)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))


def _seeded_vnet(base, **kw):
    """A seeded V-Net (relu) with BatchNorm statistics off the identity."""
    torch.manual_seed(base)
    net = SegmentationNet(1, 2, base_channels=base, **kw).eval()
    with torch.no_grad():
        for name, t in net.state_dict().items():
            if name.endswith("running_var"):
                t.uniform_(0.8, 1.2)
            elif name.endswith("running_mean") or name.endswith("bias"):
                t.normal_(0.0, 0.05)
    return net


@pytest.fixture(scope="module")
def vnet():
    """A seeded base-2 V-Net and a 32^3 volume. The int8 forward takes a
    base-4 net: its strided convs' int8 GEMMs need channel counts that are
    multiples of 8 (ops/quant.py:int_mm)."""
    vol = np.random.default_rng(3).normal(0.0, 1.0, (32, 32, 32, 1)).astype(np.float32)
    return {2: _seeded_vnet(2), 4: _seeded_vnet(4, down_convs=(1, 2), up_convs=(2, 1))}, \
        torch.from_numpy(vol)


FORWARDS = {
    "module_f32": lambda nets: module_forward(nets[2], torch.float32),
    "fused_bf16": lambda nets: build_fused_forward(nets[2], torch.bfloat16),
    "int8": lambda nets: build_int8_forward(nets[4], dtype=torch.bfloat16),
}


@pytest.mark.parametrize("kind", list(FORWARDS))
def test_vnet_forwards_match_unsharded(vnet, kind):
    """The float32 module forward and the fused bf16 and int8 forwards (the
    kernels' plain versions on the CPU) inside 2 and 8 shards."""
    nets, vol = vnet
    fwd = FORWARDS[kind](nets)
    kw = dict(batch_size=2, blend="gaussian")
    ref_m, ref_p = te.SlidingWindowInferer(fwd, (16, 16, 16), 2, **kw)(
        vol, stride_zyx=(8, 8, 8), return_prob=True)
    for n in (2, 8):
        m, p = te.SlidingWindowInferer({torch.device("cpu"): fwd}, (16, 16, 16), 2,
                                       devices=_shards(n), **kw)(
            vol, stride_zyx=(8, 8, 8), return_prob=True)
        np.testing.assert_allclose(p.numpy(), ref_p.numpy(), atol=1e-5)
        np.testing.assert_array_equal(m.numpy(), ref_m.numpy())


def test_ensemble_of_sharded_members(vnet):
    """A 2-member ensemble whose members run on 3 shards equals the same
    ensemble unsharded."""
    nets, vol = vnet
    fwds = [module_forward(nets[2], torch.float32),
            module_forward(SegmentationNet(1, 2, base_channels=2).eval(), torch.float32)]

    def members(devices):
        return [te.SlidingWindowInferer(f, (16, 16, 16), 2, batch_size=2,
                                        devices=devices) for f in fwds]
    ref_m, ref_p = ensemble_forward(members(None), vol, (8, 8, 8))
    m, p = ensemble_forward(members(_shards(3)), vol, (8, 8, 8))
    np.testing.assert_allclose(p.numpy(), ref_p.numpy(), atol=1e-5)
    np.testing.assert_array_equal(m.numpy(), ref_m.numpy())


@pytest.mark.parametrize("n", [2, 3, 8])
def test_forward_runs_once_per_real_batch(n):
    """No all-padding batch runs: 5^3 boxes in batches of 8 are 16 batches,
    split into contiguous runs of ceil(16 / n)."""
    seen = []

    def counting(x):
        seen.append(int(x.shape[0]))
        return blur(x)
    inf = te.SlidingWindowInferer(counting, PATCH, 2, batch_size=8,
                                  devices=_shards(n))
    inf(torch.from_numpy(_vol((24, 24, 24))), stride_zyx=STRIDE)
    n_boxes = len(inf.boxes_for((24, 24, 24), STRIDE))
    assert n_boxes == 125
    assert seen == [8] * 15 + [5]


def test_dice_with_shards_raises_jax_error():
    inf = te.SlidingWindowInferer(blur, PATCH, 2, devices=_shards(2))
    jinf = je.SlidingWindowInferer(_BlurNet(), PATCH, 2, mesh=make_mesh(2))
    vol = _vol((8, 8, 8))
    gt = np.zeros((8, 8, 8), np.int32)
    with pytest.raises(NotImplementedError) as ref:
        jinf.dice(None, jnp.asarray(vol), jnp.asarray(gt), (8, 8, 8))
    with pytest.raises(NotImplementedError) as got:
        inf.dice(torch.from_numpy(vol), gt, (8, 8, 8))
    assert str(got.value) == str(ref.value)
