"""Plain float32 V-Net and VB-Net, written from the papers and the toolkit.

V-Net (Milletari et al. 2016, arXiv:1606.04797) as the Medical
Segmentation 3D Toolkit builds it (``segmentation3d/network/vnet.py``): a
3^3 conv-BN-ReLU stem, four down levels (2^3 stride-2 conv doubling the
channels, BN, ReLU, a residual block of 3^3 conv-BN-ReLU layers), four up
levels (2^3 stride-2 transposed conv halving the channels, BN, ReLU, the
skip concatenated, a residual block), a 3^3 conv-BN-ReLU head to the class
count, a 1^3 projection and a softmax over the classes. A residual block
is ``relu(x + layers(x))``. VB-Net (Shan et al. 2020, arXiv:2003.04655;
``segmentation3d/network/vbnet.py``) replaces each residual layer by a
bottleneck: 1^3 conv-BN-ReLU to a quarter of the channels, 3^3
conv-BN-ReLU, 1^3 conv back and BN, with a ReLU between two bottlenecks.

BatchNorm in train mode normalises by the batch's mean and biased
variance and moves its running statistics by a tenth towards them, as
the flax net that the checkpoints come from does. The parameter names
are the checkpoint's, so one state dict loads here and in the program.

Tensors are NCDHW. Nothing here imports the program or JAX; TF32 is off
wherever this module computes on a GPU (:func:`exact`).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F


@contextlib.contextmanager
def exact():
    """float32 matmuls and convolutions without TF32, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class BN(nn.BatchNorm3d):
    """Batch statistics with the biased variance in training, running
    statistics otherwise; float32 throughout."""

    def __init__(self, c):
        super().__init__(c, eps=1e-5, momentum=0.1)

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        dims = (0, 2, 3, 4)
        mean = x.mean(dims)
        var = ((x - mean.view(1, -1, 1, 1, 1)) ** 2).mean(dims)
        with torch.no_grad():
            self.running_mean.mul_(0.9).add_(0.1 * mean)
            self.running_var.mul_(0.9).add_(0.1 * var)
            self.num_batches_tracked.add_(1)
        shape = (1, -1, 1, 1, 1)
        return ((x - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.eps)
                * self.weight.view(shape) + self.bias.view(shape))


class Layer(nn.Module):
    """k^3 conv (padding k // 2), BN, ReLU unless ``act`` is False."""

    def __init__(self, cin, cout, k=3, act=True):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, k, padding=k // 2)
        self.bn = BN(cout)
        self.use_act = act

    def forward(self, x):
        y = self.bn(self.conv(x))
        return F.relu(y) if self.use_act else y


class Bottleneck(nn.Module):
    def __init__(self, c):
        super().__init__()
        mid = max(1, c // 4)
        self.reduce = Layer(c, mid, 1)
        self.conv = Layer(mid, mid, 3)
        self.expand = nn.Conv3d(mid, c, 1)
        self.bn = BN(c)

    def forward(self, x):
        return self.bn(self.expand(self.conv(self.reduce(x))))


class Residual(nn.Module):
    def __init__(self, c, n, bottleneck):
        super().__init__()
        self.n, self.bottleneck = n, bottleneck
        for i in range(n):
            self.add_module(f"conv{i}", Bottleneck(c) if bottleneck else Layer(c, c))

    def forward(self, x):
        h = x
        for i in range(self.n):
            h = getattr(self, f"conv{i}")(h)
            if self.bottleneck and i + 1 < self.n:
                h = F.relu(h)
        return F.relu(x + h)


class Down(nn.Module):
    def __init__(self, cin, c, n, bottleneck):
        super().__init__()
        self.down_conv = nn.Conv3d(cin, c, 2, stride=2)
        self.down_bn = BN(c)
        self.res = Residual(c, n, bottleneck)

    def forward(self, x):
        return self.res(F.relu(self.down_bn(self.down_conv(x))))


class Up(nn.Module):
    def __init__(self, cin, c, n, bottleneck):
        super().__init__()
        self.up_conv = nn.ConvTranspose3d(cin, c // 2, 2, stride=2)
        self.up_bn = BN(c // 2)
        self.res = Residual(c, n, bottleneck)

    def forward(self, x, skip):
        x = F.relu(self.up_bn(self.up_conv(x)))
        return self.res(torch.cat([x, skip], 1))


class Head(nn.Module):
    def __init__(self, cin, classes):
        super().__init__()
        self.conv = Layer(cin, classes, 3)
        self.proj = nn.Conv3d(classes, classes, 1)

    def forward(self, x):
        return self.proj(self.conv(x))


class Net(nn.Module):
    """``x [B, Cin, D, H, W]`` -> class logits ``[B, classes, D, H, W]``;
    :meth:`probs` applies the softmax."""

    def __init__(self, in_channels, classes, base_channels=16,
                 down_convs=(1, 2, 3, 3), up_convs=(3, 3, 2, 1),
                 bottleneck=False):
        super().__init__()
        self.down_convs, self.up_convs = tuple(down_convs), tuple(up_convs)
        c = base_channels
        self.base = c
        self.in_block = nn.Module()
        self.in_block.conv = Layer(in_channels, c)
        for n in self.down_convs:
            self.add_module(f"down_{2 * c}", Down(c, 2 * c, n, bottleneck))
            c *= 2
        prev = c
        for n in self.up_convs:
            self.add_module(f"up_{c}", Up(prev, c, n, bottleneck))
            prev, c = c, c // 2
        self.out_block = Head(prev, classes)

    def forward(self, x):
        c = self.base
        x = self.in_block.conv(x)
        skips = [x]
        for i, _ in enumerate(self.down_convs):
            c *= 2
            x = getattr(self, f"down_{c}")(x)
            if i + 1 < len(self.down_convs):
                skips.append(x)
        for _ in self.up_convs:
            x = getattr(self, f"up_{c}")(x, skips.pop())
            c //= 2
        return self.out_block(x)

    def probs(self, x):
        return torch.softmax(self(x), dim=1)


def build(config: dict) -> Net:
    """The reference net of a configuration file's ``net`` entry."""
    n = config["net"]
    return Net(n["in_channels"], n["num_classes"], n["base_channels"],
               n["down_convs"], n["up_convs"], n["name"] == "vbnet")
