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
``[B, D, H, W, out_channels]`` in float32 (softmax over classes).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def max_stride() -> int:
    """Total down-sampling factor; crop sizes must be divisible by this."""
    return 16


class Activation(nn.Module):
    """relu, or prelu with one learned slope ``alpha`` (init 0.25)."""

    def __init__(self, kind: str = "relu"):
        super().__init__()
        if kind not in ("relu", "prelu"):
            raise ValueError(f"unknown activation {kind!r}")
        self.kind = kind
        if kind == "prelu":
            self.alpha = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, x):
        if self.kind == "relu":
            return F.relu(x)
        return torch.where(x >= 0, x, self.alpha.to(x.dtype) * x)


def _bn(c):
    return nn.BatchNorm3d(c, eps=1e-5, momentum=0.1)


class ConvBnAct(nn.Module):
    """``ksize``^3 SAME conv (3 or 1) + BatchNorm + activation."""

    def __init__(self, cin, cout, act="relu", ksize=3):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, ksize, padding=ksize // 2)
        self.bn = _bn(cout)
        self.act = Activation(act)

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


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
        x = self.proj(self.conv(x)).to(torch.float32)
        return x if return_logits else torch.softmax(x, dim=1)


class SegmentationNet(nn.Module):
    """V-Net encoder-decoder (``bottleneck=True``: VB-Net). D/H/W of the
    input must be divisible by :meth:`max_stride`."""

    def __init__(self, in_channels: int, out_channels: int,
                 base_channels: int = 16,
                 down_convs: Sequence[int] = (1, 2, 3, 3),
                 up_convs: Sequence[int] = (3, 3, 2, 1),
                 act: str = "relu", bottleneck: bool = False):
        super().__init__()
        self.in_channels = int(in_channels)
        self.out_channels = int(out_channels)
        self.base_channels = int(base_channels)
        self.down_convs = tuple(int(n) for n in down_convs)
        self.up_convs = tuple(int(n) for n in up_convs)
        self.act = act
        self.bottleneck = bool(bottleneck)
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
            x = getattr(self, f"down_{c}")(x)
            if i + 1 < len(self.down_convs):
                skips.append(x)
        for _ in self.up_convs:
            x = getattr(self, f"up_{c}")(x, skips.pop())
            c //= 2
        out = self.out_block(x, return_logits)
        return out.permute(0, 2, 3, 4, 1)
