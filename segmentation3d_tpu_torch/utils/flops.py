"""Analytic FLOP counts for the V-Net forward (performance accounting).

The port's own copy of ``segmentation3d_tpu/utils/flops.py``.
``vnet_forward_flops`` counts the useful dense FLOPs of one forward pass:
the multiply-adds of the direct convolution (2 * K^3 * Cin * Cout per
output voxel), whichever kernel executes them. A roofline bound divides it
by :data:`H100_PEAK_BF16_FLOPS`.

One difference from the JAX package's count, which is a fault there: every
transposed conv after the first up block reads the previous up block's
output, ``2 * c`` channels, not ``c``; this count uses the channels the
net has, so it equals a forward-hook count of the port's
``SegmentationNet`` (e.g. 180.8 GFLOP for a 96^3 patch of the default
net).
"""
from __future__ import annotations

import numpy as np

#: Dense bf16 tensor-core rate of one NVIDIA H100 SXM (NVIDIA's data sheet,
#: without sparsity, at its 700 W limit).
H100_PEAK_BF16_FLOPS = 989e12


def vnet_forward_flops(patch_zyx, in_channels, out_channels,
                       base_channels=16, down_convs=(1, 2, 3, 3),
                       up_convs=(3, 3, 2, 1)) -> float:
    """Useful FLOPs of ONE V-Net forward on a ``patch_zyx``-shaped patch.

    Counts every conv as 2 * prod(kernel) * Cin * Cout * out_voxels
    (multiply + add), the k=2/s=2 transposed conv as 2 * Cin * Cout per
    OUTPUT voxel (each output voxel reads exactly one input position), and
    ignores BN/activation/softmax (bandwidth-bound elementwise, < 0.1% of
    the total). Architecture mirrors ``models/vnet.py:SegmentationNet``.
    """
    v = float(np.prod(patch_zyx))
    base = int(base_channels)
    total = 2.0 * 27 * in_channels * base * v  # in_block stem

    c = base
    vol = v
    enc = []
    for nconv in down_convs:
        c2 = c * 2
        vol2 = vol / 8.0
        total += 2.0 * 8 * c * c2 * vol2          # k2/s2 down conv
        total += nconv * 2.0 * 27 * c2 * c2 * vol2  # residual convs
        enc.append((c, vol))
        c, vol = c2, vol2
    prev = c  # channels of the tensor each up block's deconv reads
    for nconv in up_convs:
        _, vol_up = enc.pop()
        up = c // 2
        total += 2.0 * prev * up * vol_up         # k2/s2 deconv (1 tap/output)
        # res convs run on the concat (up + skip == c) at full feature width
        total += nconv * 2.0 * 27 * c * c * vol_up
        prev, c, vol = c, c // 2, vol_up
    # out_block: 3^3 conv (2*base -> nc) + 1x1x1 projection (nc -> nc)
    total += 2.0 * 27 * prev * out_channels * v
    total += 2.0 * out_channels * out_channels * v
    return total


def vnet_train_step_flops(patch_zyx, in_channels, out_channels,
                          batch: int = 1, **net_kwargs) -> float:
    """Useful FLOPs of ONE training step (fwd + bwd) on ``batch`` patches:
    backward costs about twice the forward (one matmul-shaped pass for the
    activation gradients, one for the weight gradients), so a step is 3x
    the forward. A recomputed forward (``remat``) is overhead, not useful
    work, so it is not counted."""
    return 3.0 * batch * vnet_forward_flops(
        patch_zyx, in_channels, out_channels, **net_kwargs)


def sliding_window_flops(volume_zyx, patch_zyx, stride_zyx, in_channels,
                         out_channels, **net_kwargs) -> float:
    """Useful FLOPs of a whole sliding-window pass: per-patch forward FLOPs
    times the number of boxes the engine runs (overlap re-computation is
    counted as useful — the blending requires those voxels)."""
    from segmentation3d_tpu_torch.ops.geometry import partition_boxes
    boxes = partition_boxes(np.asarray(volume_zyx)[::-1],
                            np.asarray(patch_zyx)[::-1],
                            np.asarray(stride_zyx)[::-1])
    return len(boxes) * vnet_forward_flops(patch_zyx, in_channels,
                                           out_channels, **net_kwargs)
