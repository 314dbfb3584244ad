"""Seeded weights for the reference SwinUNETR, made on the card.

No trained SwinUNETR weights are in reach, so the benchmark makes them
from one generator: He-normal convolutions, linear layers at unit gain
(``1 / sqrt(fan in)``, so that attention scores spread over a few units as
a trained net's do), LayerNorm scales about 1, small biases, and a
relative-position bias table of unit spread (each head prefers some
offsets). Then the 14-class head (a 1^3 conv) is fitted by least squares
on two phantom boxes at the model's spacing: eight classes are bands of
Hounsfield units (air, lung, fat, soft tissue, three organs, bone), the
other six are never the answer. A random head leaves most voxels near a
tie among its classes, and a mask check on it says nothing.

The result is a state dict under the program's names, which the benchmark
hands to the program and to the plain reference alike.
"""
from __future__ import annotations

import torch

from portbench.cases import phantom
from portbench.reference.nets import exact

#: upper edges (HU) of the fitted classes 0..6; class 7 above the last
BANDS = (-800.0, -300.0, -50.0, 50.0, 100.0, 175.0, 400.0)
#: the fitted class's target logit, every other class's being 0
TARGET = 4.0


def _draw(net, gen):
    dev = gen.device
    with torch.no_grad():
        for name, p in net.named_parameters():
            r = torch.randn(p.shape, generator=gen, device=dev)
            if name.endswith("relative_position_bias_table"):
                p.copy_(r)
            elif p.dim() == 5:                                   # conv, transposed conv
                transposed = ".transp_conv." in name
                fan_in = p.shape[0] if transposed else p[0].numel()
                p.copy_(r * (2.0 / fan_in) ** 0.5)
            elif p.dim() == 2:                                   # linear
                p.copy_(r / p.shape[1] ** 0.5)
            elif ".norm" in name and name.endswith("weight"):    # LayerNorm scale
                p.copy_(1.0 + 0.1 * r)
            else:                                                # biases, LayerNorm shift
                p.copy_(0.05 * r)


def _boxes(gen, patch, spacing_zyx, norm):
    """Two phantom boxes at the model's spacing, one inside the body and
    one across its edge: ``(x [2, 1, D, H, W], hu)``."""
    hu = torch.stack([phantom(patch, spacing_zyx, shift, gen)[0]
                      for shift in ((0.5, -11.5, 68.5), (0.5, 88.5, 0.5))]).float()
    x = (hu - norm["mean"]) / norm["stddev"]
    return (x.clamp(-1, 1) if norm["clip"] else x)[:, None], hu


@torch.no_grad()
def _fit_head(net, gen, cfg, patch):
    x, hu = _boxes(gen, patch, tuple(cfg["spacing_mm"][::-1]), cfg["normalizer"])
    feats = []
    head = net.out.conv.conv
    hook = head.register_forward_hook(lambda m, i, o: feats.append(i[0]))
    net(x)
    hook.remove()
    f = feats[0].permute(0, 2, 3, 4, 1).reshape(-1, head.in_channels)
    pick = torch.randperm(len(f), generator=gen, device=gen.device)[:60000]
    a = torch.cat([f[pick], torch.ones(len(pick), 1, device=f.device)], 1).double()
    cls = torch.bucketize(hu.reshape(-1)[pick], torch.tensor(BANDS, device=hu.device))
    target = torch.zeros(len(pick), head.out_channels, dtype=torch.float64, device=f.device)
    target[torch.arange(len(pick)), cls] = TARGET
    coef = torch.linalg.solve(a.T @ a + 1e-6 * torch.eye(a.shape[1], device=a.device,
                                                            dtype=a.dtype), a.T @ target)
    head.weight.copy_(coef[:-1].T.reshape(head.weight.shape).float())
    head.bias.copy_(coef[-1].float())


def seeded(net, seed, cfg, device, fit=True):
    """Give the reference ``net`` (moved to ``device``) its seeded weights;
    returns it in eval mode."""
    net.to(device).eval()
    gen = torch.Generator(device=device).manual_seed(int(seed) ^ 0x5EED)
    _draw(net, gen)
    if fit:
        with exact():
            _fit_head(net, gen, cfg, tuple(cfg["crop"]))
    return net

