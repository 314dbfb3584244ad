"""V-Net (Milletari et al. 2016) as a PyTorch ``nn.Module``.

The port of ``segmentation3d_tpu/models/vnet.py:SegmentationNet``, with the
standard blocks and, with ``bottleneck=True`` (the ``vbnet`` registry
entry), the bottleneck residual chains: ``BottConvBnAct`` (1x1x1 reduce by
4 -> 3x3x3 -> 1x1x1 expand + BatchNorm) with an activation ``act<i>``
between the chain's blocks. Its ``state_dict`` names and layouts equal the
checkpoint's (``in_block.conv.conv.weight``, ``down_32.down_conv.weight``,
``up_32.res.conv0.bn.running_var``, ``down_32.res.conv0.reduce.conv.weight``,
``*.num_batches_tracked``, PReLU's ``*.act.alpha`` of shape (1,)), so a
``params.pth`` written by the JAX package loads with
``load_state_dict(strict=True)``. Transposed-conv weights
are stored already flipped into ``ConvTranspose3d``'s convention.

Public layout is channels-last, as in JAX: ``forward`` takes
``[B, D, H, W, in_channels]`` and returns per-class probabilities
``[B, D, H, W, out_channels]`` in float32 (softmax over classes; float64
for a float64 net).

Training follows flax: :class:`BatchNorm` normalizes by the batch's biased
variance in float32 and moves its running statistics by 0.1 towards the
batch's mean and biased variance, once per step even when ``remat`` (the
JAX package's ``cfg.tpu.remat``: the down and up blocks recomputed in
backward) runs its forward twice; :func:`init_like_flax_` draws flax's
``he_normal`` weights; :func:`vnet_focal_init` sets the focal-loss head
bias. Under ``torch.autocast(bfloat16)`` the convs run in bf16 and
BatchNorm and the softmax in float32, as the flax net with ``dtype=bf16``.

Over several ranks (:func:`distribute_`), in train mode, BatchNorm takes its
statistics over every rank's rows and z planes (one all-reduce of the sums
forward, one backward), as flax's BatchNorm does over a sharded batch under
``jit``, and each 3^3 conv takes a plane of halo from its z neighbours
(``parallel/collectives.py``). In eval mode the net runs on what it is
given, with no collective.
"""
from __future__ import annotations

import contextlib
import math
from typing import Sequence

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from segmentation3d_tpu_torch.parallel.collectives import halo_exchange_z

#: flax's truncated-normal correction: the std of a unit normal cut at +-2
TRUNC_STD = 0.87962566103423978


def max_stride() -> int:
    """Total down-sampling factor; crop sizes must be divisible by this."""
    return 16


class Activation(nn.Module):
    """relu, leaky_relu (slope 0.01), or prelu with one learned slope
    ``alpha`` (init 0.25)."""

    def __init__(self, kind: str = "relu"):
        super().__init__()
        if kind not in ("relu", "prelu", "leaky_relu"):
            raise ValueError(f"unknown activation {kind!r}")
        self.kind = kind
        if kind == "prelu":
            self.alpha = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, x):
        if self.kind == "relu":
            return F.relu(x)
        if self.kind == "leaky_relu":
            return F.leaky_relu(x, 0.01)
        return torch.where(x >= 0, x, self.alpha.to(x.dtype) * x)


class _BatchStatsNorm(torch.autograd.Function):
    """Train-mode normalization with flax's statistics: ``mean = E[x]``,
    ``var = max(E[x^2] - E[x]^2, 0)`` (flax's fast variance, the biased
    one), ``y = (x - mean) * (rsqrt(var + eps) * scale) + bias``, all in
    float32. Its gradient is BatchNorm's (the fast variance is the variance),
    so the backward is ATen's, from the saved input and statistics."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        mean = torch.mean(x, dims)
        var = torch.clamp_min(torch.mean(x * x, dims) - mean * mean, 0.0)
        invstd = torch.rsqrt(var + eps)
        y = torch.addcmul(bias.view(shape), x - mean.view(shape),
                          (invstd * weight).view(shape))
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.eps = eps
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, weight, mean, invstd = ctx.saved_tensors
        gx, gw, gb = torch.ops.aten.native_batch_norm_backward(
            gy.contiguous(), x, weight, None, None, mean, invstd, True, ctx.eps,
            list(ctx.needs_input_grad[:3]))
        return gx, gw, gb, None


class _SyncBatchStatsNorm(torch.autograd.Function):
    """:class:`_BatchStatsNorm` over the ranks of ``group``: the mean and
    fast variance of every rank's values (one all-reduce of ``[sum(x),
    sum(x^2), count]`` per channel, in the input's float type), and
    BatchNorm's input gradient from the all-reduced ``[sum(gy),
    sum(gy * xhat)]``. The weight and bias gradients stay this rank's own
    sums: DDP sums them over the ranks. Plain tensor ops (ATen's
    ``batch_norm_backward_reduce`` has no CPU kernel)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        n = torch.full((1,), x.numel() / x.shape[1], dtype=x.dtype, device=x.device)
        sums = torch.cat([torch.sum(x, dims), torch.sum(x * x, dims), n])
        dist.all_reduce(sums, group=group)
        c = x.shape[1]
        count = sums[2 * c]
        mean = sums[:c] / count
        var = torch.clamp_min(sums[c:2 * c] / count - mean * mean, 0.0)
        invstd = torch.rsqrt(var + eps)
        y = torch.addcmul(bias.view(shape), x - mean.view(shape),
                          (invstd * weight).view(shape))
        ctx.save_for_backward(x, weight, mean, invstd, count)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, weight, mean, invstd, count = ctx.saved_tensors
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        xhat = (x - mean.view(shape)) * invstd.view(shape)
        gb = torch.sum(gy, dims)
        gw = torch.sum(gy * xhat, dims)
        sums = torch.cat([gb, gw])
        dist.all_reduce(sums, group=ctx.group)
        c = x.shape[1]
        gx = (weight * invstd).view(shape) * (
            gy - (sums[:c] / count).view(shape)
            - xhat * (sums[c:] / count).view(shape))
        return gx, gw, gb, None, None


class BatchNorm(nn.BatchNorm3d):
    """BatchNorm as flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5,
    dtype=float32)`` computes it, with ``BatchNorm3d``'s parameter and
    buffer names. The statistics and the normalization are float32 for a
    bf16 or float32 input (float64 for float64); the output has the
    input's type. In train mode the
    batch is normalized by its mean and BIASED variance, taken as flax
    takes it (:class:`_BatchStatsNorm`; one value per channel gives
    variance 0, where ``BatchNorm3d`` raises) and, while ``update_stats``
    is set, ``running = 0.9 * running + 0.1 * batch`` for the mean and that
    variance (``BatchNorm3d`` moves ``running_var`` towards the unbiased
    one). With a process ``group`` (:func:`distribute_`) the train-mode
    statistics are those of every rank's values (:class:`_SyncBatchStatsNorm`),
    equal on every rank."""

    def __init__(self, c):
        super().__init__(c, eps=1e-5, momentum=0.1)
        self.update_stats = True
        self.group = None

    def forward(self, x):
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        if not self.training:
            y = F.batch_norm(x32, self.running_mean, self.running_var,
                             self.weight, self.bias, False, 0.0, self.eps)
            return y.to(x.dtype)
        if self.group is None:
            y, mean, var = _BatchStatsNorm.apply(x32, self.weight, self.bias,
                                                 self.eps)
        else:
            y, mean, var = _SyncBatchStatsNorm.apply(x32, self.weight, self.bias,
                                                     self.eps, self.group)
        if self.update_stats:
            with torch.no_grad():
                self.running_mean.copy_(0.9 * self.running_mean + 0.1 * mean)
                self.running_var.copy_(0.9 * self.running_var + 0.1 * var)
                self.num_batches_tracked.add_(1)
        return y.to(x.dtype)


def _bn(c):
    return BatchNorm(c)


@contextlib.contextmanager
def frozen_stats(module: nn.Module):
    """Within the block, BatchNorm layers of ``module`` leave their running
    statistics alone (the recomputed forward of a checkpointed block)."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    prev = [m.update_stats for m in bns]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m, p in zip(bns, prev):
            m.update_stats = p


class ConvBnAct(nn.Module):
    """``ksize``^3 SAME conv (3 or 1) + BatchNorm + activation. With a
    ``halo_group`` (a 3^3 conv over z slabs, :func:`distribute_`) the
    training forward takes one plane from each z neighbour and pads only
    y and x."""

    def __init__(self, cin, cout, act="relu", ksize=3):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, ksize, padding=ksize // 2)
        self.bn = _bn(cout)
        self.act = Activation(act)
        self.halo_group = None

    def forward(self, x):
        if self.halo_group is not None and self.training:
            x = F.conv3d(halo_exchange_z(x, self.halo_group), self.conv.weight,
                         self.conv.bias, padding=(0, 1, 1))
        else:
            x = self.conv(x)
        return self.act(self.bn(x))


class BottConvBnAct(nn.Module):
    """Bottleneck block: 1x1x1 conv-BN-act reducing ``c`` by ``ratio`` ->
    3x3x3 conv-BN-act -> 1x1x1 expand back to ``c`` + BatchNorm (no
    activation)."""

    def __init__(self, c, ratio=4, act="relu"):
        super().__init__()
        mid = max(1, c // ratio)
        self.reduce = ConvBnAct(c, mid, act, ksize=1)
        self.conv = ConvBnAct(mid, mid, act)
        self.expand = nn.Conv3d(mid, c, 1)
        self.bn = _bn(c)

    def forward(self, x):
        return self.bn(self.expand(self.conv(self.reduce(x))))


class ResidualBlock(nn.Module):
    """``act(x + convs(x))`` over ``num_convs`` conv-BN-act layers, or over
    ``num_convs`` bottleneck blocks with an activation ``act<i>`` after
    each but the last."""

    def __init__(self, c, num_convs, act="relu", bottleneck=False):
        super().__init__()
        self.num_convs = num_convs
        self.bottleneck = bottleneck
        for i in range(num_convs):
            if bottleneck:
                self.add_module(f"conv{i}", BottConvBnAct(c, 4, act))
                if i + 1 < num_convs:
                    self.add_module(f"act{i}", Activation(act))
            else:
                self.add_module(f"conv{i}", ConvBnAct(c, c, act))
        self.act_out = Activation(act)

    def forward(self, x):
        h = x
        for i in range(self.num_convs):
            h = getattr(self, f"conv{i}")(h)
            if self.bottleneck and i + 1 < self.num_convs:
                h = getattr(self, f"act{i}")(h)
        return self.act_out(x + h)


class InputBlock(nn.Module):
    def __init__(self, cin, c, act="relu"):
        super().__init__()
        self.conv = ConvBnAct(cin, c, act)

    def forward(self, x):
        return self.conv(x)


class DownBlock(nn.Module):
    """Stride-2 2x2x2 conv doubling channels + residual block."""

    def __init__(self, cin, c, num_convs, act="relu", bottleneck=False):
        super().__init__()
        self.down_conv = nn.Conv3d(cin, c, 2, stride=2)
        self.down_bn = _bn(c)
        self.down_act = Activation(act)
        self.res = ResidualBlock(c, num_convs, act, bottleneck)

    def forward(self, x):
        return self.res(self.down_act(self.down_bn(self.down_conv(x))))


class UpBlock(nn.Module):
    """Stride-2 2x2x2 transposed conv halving channels + skip concat +
    residual block. ``c`` is the channel count after the concat."""

    def __init__(self, cin, c, num_convs, act="relu", bottleneck=False):
        super().__init__()
        self.up_conv = nn.ConvTranspose3d(cin, c // 2, 2, stride=2)
        self.up_bn = _bn(c // 2)
        self.up_act = Activation(act)
        self.res = ResidualBlock(c, num_convs, act, bottleneck)

    def forward(self, x, skip):
        x = self.up_act(self.up_bn(self.up_conv(x)))
        return self.res(torch.cat([x, skip], dim=1))


class OutputBlock(nn.Module):
    """3x3x3 conv-BN-act -> 1x1x1 conv -> softmax over classes."""

    def __init__(self, cin, out_channels, act="relu"):
        super().__init__()
        self.conv = ConvBnAct(cin, out_channels, act)
        self.proj = nn.Conv3d(out_channels, out_channels, 1)

    def forward(self, x, return_logits=False):
        x = self.proj(self.conv(x))
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        return x if return_logits else torch.softmax(x, dim=1)


class SegmentationNet(nn.Module):
    """V-Net encoder-decoder (``bottleneck=True``: VB-Net). D/H/W of the
    input must be divisible by :meth:`max_stride`."""

    def __init__(self, in_channels: int, out_channels: int,
                 base_channels: int = 16,
                 down_convs: Sequence[int] = (1, 2, 3, 3),
                 up_convs: Sequence[int] = (3, 3, 2, 1),
                 act: str = "relu", bottleneck: bool = False,
                 remat: bool = False):
        super().__init__()
        self.in_channels = int(in_channels)
        self.out_channels = int(out_channels)
        self.base_channels = int(base_channels)
        self.down_convs = tuple(int(n) for n in down_convs)
        self.up_convs = tuple(int(n) for n in up_convs)
        self.act = act
        self.bottleneck = bool(bottleneck)
        self.remat = bool(remat)
        c = self.base_channels
        self.in_block = InputBlock(self.in_channels, c, act)
        for n in self.down_convs:
            self.add_module(f"down_{2 * c}",
                            DownBlock(c, 2 * c, n, act, self.bottleneck))
            c *= 2
        prev = c
        for n in self.up_convs:
            # up_<c>: the previous block's channels -> c // 2 after the
            # deconv, c after the concat with the skip of c // 2 channels
            self.add_module(f"up_{c}", UpBlock(prev, c, n, act, self.bottleneck))
            prev = c
            c //= 2
        self.out_block = OutputBlock(prev, self.out_channels, act)

    def max_stride(self) -> int:
        return 2 ** len(self.down_convs)

    @property
    def foldable(self) -> bool:
        """Whether the BN-folded forward applies: an activation the
        kernel's epilogue applies (not leaky_relu), with standard or
        bottleneck blocks. The int8 forward needs standard blocks too
        (:func:`..core.seg_infer.build_forward`)."""
        from segmentation3d_tpu_torch.models.fused_vnet import FOLDED_ACTS
        return self.act in FOLDED_ACTS

    def _block(self, block, *args):
        """``block(*args)``; with ``remat`` in training, only its inputs are
        kept for backward and its forward runs again there, its BatchNorm
        statistics moved once."""
        if not (self.remat and self.training and torch.is_grad_enabled()):
            return block(*args)
        return checkpoint(block, *args, use_reentrant=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              frozen_stats(block)))

    def forward(self, x, return_logits: bool = False):
        """``x [B, D, H, W, in_channels]`` -> ``[B, D, H, W, out_channels]``."""
        if x.shape[-1] != self.in_channels:
            raise ValueError(f"expected {self.in_channels} input channels, "
                             f"got {tuple(x.shape)}")
        x = x.permute(0, 4, 1, 2, 3)
        c = self.base_channels
        x = self.in_block(x)
        skips = [x]
        for i, _ in enumerate(self.down_convs):
            c *= 2
            x = self._block(getattr(self, f"down_{c}"), x)
            if i + 1 < len(self.down_convs):
                skips.append(x)
        for _ in self.up_convs:
            x = self._block(getattr(self, f"up_{c}"), x, skips.pop())
            c //= 2
        out = self.out_block(x, return_logits)
        return out.permute(0, 2, 3, 4, 1)


def distribute_(net: nn.Module, batch_group=None, z_group=None):
    """Train ``net`` over several ranks: every BatchNorm takes its statistics
    over the ranks of ``batch_group`` (all of them: each holds its rows and
    z planes of the batch), every 3^3 conv its z halo from the ranks of
    ``z_group`` (those that hold the same rows; None: whole crops). None
    and None is the one-device net."""
    for m in net.modules():
        if isinstance(m, BatchNorm):
            m.group = batch_group
        elif isinstance(m, ConvBnAct) and m.conv.kernel_size[0] == 3:
            m.halo_group = z_group
    return net


def init_like_flax_(net: nn.Module, generator: torch.Generator | None = None):
    """Initialize ``net`` as the flax V-Net initializes itself: every conv
    and transposed-conv weight from flax's ``he_normal`` (a normal cut at
    +-2 std, scaled to ``sqrt(2 / fan_in) / 0.8796``, ``fan_in`` = kernel
    volume x input channels, as flax counts it for both), biases 0,
    BatchNorm scale 1 and bias 0 with running mean 0 and variance 1, PReLU
    alpha 0.25. Draws from ``generator`` (default: torch's global one)."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
                w = m.weight
                cin = w.shape[0] if isinstance(m, nn.ConvTranspose3d) else w.shape[1]
                fan_in = cin * w[0, 0].numel()
                nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
                w.mul_(math.sqrt(2.0 / fan_in) / TRUNC_STD)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm):
                m.reset_parameters()
            elif isinstance(m, Activation) and m.kind == "prelu":
                m.alpha.fill_(0.25)
    return net


def vnet_focal_init(net: "SegmentationNet", obj_p: float = 0.01):
    """Focal-loss head bias (JAX ``models/vnet.py:vnet_focal_init``): object
    classes start at prior probability ``obj_p`` after the softmax,
    ``bias = -log((1 - p) / p)``, background 0."""
    with torch.no_grad():
        bias = net.out_block.proj.bias
        bias.fill_(-math.log((1.0 - obj_p) / obj_p))
        bias[0] = 0.0
    return net
