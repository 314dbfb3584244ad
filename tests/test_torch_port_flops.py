"""``utils/flops.py`` of the port against the JAX package's and against a
forward-hook count on the port's net.

The JAX package counts each transposed conv after the first up block as if
it read ``c`` channels; it reads the previous block's ``2 * c``. The port
counts what the net computes, so it equals the hook count exactly, equals
the JAX count exactly where that fault cannot arise (a single up stage),
and elsewhere differs from it by exactly the missing half of those
deconvs."""
import numpy as np
import pytest
import torch

from segmentation3d_tpu.utils import flops as jax_flops
from segmentation3d_tpu_torch.models.vnet import SegmentationNet
from segmentation3d_tpu_torch.utils import flops

ARCHS = {
    "default": dict(),
    "base8_2lvl": dict(base_channels=8, down_convs=(1, 2), up_convs=(2, 1)),
    "base4_3lvl": dict(base_channels=4, down_convs=(1, 2, 3), up_convs=(3, 2, 1)),
}


def hook_flops(net, shape):
    """2 x Cin x Cout x k^3 per output voxel of each conv, per input voxel of
    each transposed conv, from the shapes a forward meets."""
    total = []

    def hook(m, inp, out):
        k = m.weight[0, 0].numel()
        if isinstance(m, torch.nn.ConvTranspose3d):
            total.append(2 * inp[0].numel() * m.out_channels * k)
        else:
            total.append(2 * out.numel() * m.in_channels * k)
    hooks = [m.register_forward_hook(hook) for m in net.modules()
             if isinstance(m, (torch.nn.Conv3d, torch.nn.ConvTranspose3d))]
    with torch.no_grad():
        net.eval()(torch.zeros(shape))
    for h in hooks:
        h.remove()
    return sum(total)


def jax_deconv_shortfall(patch, base_channels=16, down_convs=(1, 2, 3, 3),
                         up_convs=(3, 3, 2, 1)):
    """What the JAX count leaves out: 2 x c x (c / 2) per output voxel of
    every deconv but the first (it reads 2c channels, counted as c)."""
    c = base_channels * 2 ** len(down_convs)
    vol = float(np.prod(patch)) / 8 ** len(down_convs)
    missing = 0.0
    for i in range(len(up_convs)):
        vol *= 8
        if i:
            missing += 2.0 * c * (c // 2) * vol
        c //= 2
    return missing


@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_flops_equal_hook_count(arch):
    kw = ARCHS[arch]
    net = SegmentationNet(2, 3, **kw)
    assert flops.vnet_forward_flops((32, 32, 32), 2, 3, **kw) == \
        hook_flops(net, (1, 32, 32, 32, 2))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_flops_against_jax(arch):
    kw = ARCHS[arch]
    for patch in ((32, 32, 32), (96, 96, 96), (64, 32, 48)):
        ours = flops.vnet_forward_flops(patch, 1, 2, **kw)
        theirs = jax_flops.vnet_forward_flops(patch, 1, 2, **kw)
        assert ours - theirs == jax_deconv_shortfall(patch, **kw)


@pytest.mark.parametrize("kw", [dict(base_channels=4, down_convs=(2,), up_convs=(1,)),
                                dict(base_channels=16, down_convs=(3,), up_convs=(2,))])
def test_equal_to_jax_with_one_up_stage(kw):
    for patch in ((32, 32, 32), (48, 16, 32)):
        assert flops.vnet_forward_flops(patch, 1, 2, **kw) == \
            jax_flops.vnet_forward_flops(patch, 1, 2, **kw)
        assert flops.vnet_train_step_flops(patch, 1, 2, batch=8, **kw) == \
            jax_flops.vnet_train_step_flops(patch, 1, 2, batch=8, **kw)
        assert flops.sliding_window_flops((64, 64, 64), patch, (16, 16, 16), 1, 2, **kw) \
            == jax_flops.sliding_window_flops((64, 64, 64), patch, (16, 16, 16), 1, 2, **kw)


def test_step_and_sliding_window_scale_the_forward():
    one = flops.vnet_forward_flops((32, 32, 32), 1, 2)
    assert flops.vnet_train_step_flops((32, 32, 32), 1, 2, batch=8) == 24 * one
    assert flops.sliding_window_flops((64, 64, 64), (32, 32, 32), (32, 32, 32), 1, 2) \
        == 8 * one
    assert flops.sliding_window_flops((64, 64, 64), (32, 32, 32), (16, 16, 16), 1, 2) \
        == 27 * one
    # the main path's 96^3 patch of the default net (PERF.md's count)
    assert flops.vnet_forward_flops((96, 96, 96), 1, 2) == 180804648960.0
    assert flops.H100_PEAK_BF16_FLOPS == 989e12
