"""Seeded weights for the reference nets, made on the card.

Weights of a trained segmentation net are not public for these shapes, so
the benchmark makes them: He-normal conv weights and random BatchNorm
affines from one generator in a few large draws, then the BatchNorm
statistics of two phantom patches at the model's spacing (one inside the
body, one across its edge), as training would leave them, and a head conv
fitted by least squares to the patches' soft tissue (above -30 HU), so that
masks have foreground with a margin as a trained net's do. A random head
leaves most voxels at one logit, and a mask check on it says nothing.

The result is a state dict under the checkpoint's names, which the
benchmark hands to the program and to the plain reference alike.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.cases import phantom
from portbench.reference.nets import BN, Residual, exact


def _normalise(hu, norm):
    x = (hu.to(torch.float32) - norm["mean"]) / norm["stddev"]
    return x.clamp(-1, 1) if norm["clip"] else x


def _draw(net, gen):
    """He-normal weights, BatchNorm affines and statistics, small biases."""
    convs = [m for m in net.modules() if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d))]
    dev = gen.device
    with torch.no_grad():
        flat = torch.randn(sum(m.weight.numel() for m in convs), generator=gen, device=dev)
        i = 0
        for m in convs:
            w = m.weight
            fan_in = w.shape[0] if isinstance(m, nn.ConvTranspose3d) else w[0].numel()
            w.copy_(flat[i:i + w.numel()].view_as(w) * (2.0 / fan_in) ** 0.5)
            i += w.numel()
        bns = [m for m in net.modules() if isinstance(m, BN)]
        vecs = [t for m in bns for t in (m.weight, m.running_var)]
        u = torch.rand(sum(t.numel() for t in vecs), generator=gen, device=dev)
        small = [t for m in bns for t in (m.bias, m.running_mean)] + \
            [m.bias for m in convs if m.bias is not None]
        r = torch.randn(sum(t.numel() for t in small), generator=gen, device=dev)
        for pool, ts, f in ((u, vecs, lambda v: v * 0.5 + 0.75),
                            (r, small, lambda v: v * 0.1)):
            i = 0
            for t in ts:
                t.copy_(f(pool[i:i + t.numel()]).view_as(t))
                i += t.numel()
        for bn in branch_ends(net):
            bn.weight.mul_(BRANCH_GAIN)


#: the scale of each residual branch's last BatchNorm, against the skip
BRANCH_GAIN = 0.2


def branch_ends(net):
    """The BatchNorm that ends each residual branch: a bottleneck's last,
    or the last layer's of a plain residual block."""
    for m in net.modules():
        if isinstance(m, Residual):
            last = getattr(m, f"conv{m.n - 1}")
            yield last.bn


def _patches(gen, patch, norm):
    """Two phantom patches at 1 mm: ``(x [2, 1, D, H, W], fit, fg)``."""
    hus = [phantom(patch, (1.0, 1.0, 1.0), shift, gen)[0]
           for shift in ((0.5, -11.5, 68.5), (0.5, 88.5, 0.5))]
    hu = torch.stack(hus)
    return _normalise(hu, norm)[:, None], hu > -500, hu > -30


@torch.no_grad()
def _calibrate(net, gen, patch, norm):
    x, fit, fg = _patches(gen, patch, norm)
    bns = [m for m in net.modules() if isinstance(m, BN)]
    stats = {}

    def grab(m, inp, out):
        t = inp[0]
        mean = t.mean((0, 2, 3, 4))
        stats[m] = (mean, (t * t).mean((0, 2, 3, 4)) - mean * mean)
    hooks = [m.register_forward_hook(grab) for m in bns]
    net.train()
    with exact():
        net(x)
    for h in hooks:
        h.remove()
    for m in bns:
        m.running_mean.copy_(stats[m][0])
        m.running_var.copy_(stats[m][1].clamp_min(0))
    net.eval()
    feats = []
    head = net.out_block
    hook = head.conv.conv.register_forward_hook(lambda m, i, o: feats.append(i[0]))
    with exact():
        net(x)
    hook.remove()
    f = F.pad(feats[0], (1, 1, 1, 1, 1, 1))
    vox = torch.nonzero(fit)
    pick = torch.randperm(len(vox), generator=gen, device=gen.device)[:60000]
    n, z, y, xx = vox[pick].T
    a = torch.cat([f[n, :, z + dz, y + dy, xx + dx] for dz in range(3)
                   for dy in range(3) for dx in range(3)], dim=1).double()
    a = torch.cat([a, torch.ones(len(a), 1, dtype=a.dtype, device=a.device)], dim=1)
    target = fg[n, z, y, xx].double() * 2 - 1
    coef = torch.linalg.solve(a.T @ a, a.T @ target).float()
    w = coef[:-1].view(3, 3, 3, -1).permute(3, 0, 1, 2)
    conv, bn = head.conv.conv, head.conv.bn
    # class 1 is q = w * f + b and class 0 is -q; the BatchNorm is the
    # identity plus 1, so the ReLU keeps the log-odds q where |q| <= 1
    conv.weight.copy_(torch.stack([-w, w]))
    conv.bias.copy_(torch.stack([-coef[-1], coef[-1]]))
    bn.running_mean.zero_()
    bn.running_var.fill_(1.0 - bn.eps)
    bn.weight.fill_(1.0)
    bn.bias.fill_(1.0)
    head.proj.weight.copy_(0.5 * torch.eye(2, device=w.device).view(2, 2, 1, 1, 1))
    head.proj.bias.zero_()


def seeded(net, seed, cfg, device, calibrate=True):
    """Give ``net`` (a reference net, moved to ``device``) its seeded
    weights; returns it in eval mode."""
    net.to(device)
    gen = torch.Generator(device=device).manual_seed(int(seed) ^ 0x5EED)
    _draw(net, gen)
    if calibrate:
        _calibrate(net, gen, tuple(cfg["crop"]), cfg["normalizer"])
    return net.eval()
