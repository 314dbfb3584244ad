"""The reference one precision step below bf16: convolutions in fp8 or int8.

Controls for the correctness limits, not paths of the program. In fp8
every convolution's input and weight are rounded to ``float8_e4m3fn`` with
one scale per tensor (its largest magnitude onto 448, the format's largest
finite value); in int8 the weight to 255 levels per output channel and the
input to 255 levels per tensor, each symmetric about 0 with its largest
magnitude onto 127. Both compute in float32 from the rounded values, and
the gradient passes straight through the rounding.
"""
from __future__ import annotations

import copy
import types

import torch
import torch.nn as nn
import torch.nn.functional as F

FP8_MAX = 448.0


def fp8(t):
    """``t`` rounded to fp8 with a per-tensor scale, back in its type; the
    gradient is the identity's."""
    s = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (t.detach() / s).to(torch.float8_e4m3fn).to(t.dtype) * s
    return t + (q - t).detach()


def int8(t, channel_dim=None):
    """``t`` on 255 symmetric levels, one scale per tensor or per index of
    ``channel_dim``; the gradient is the identity's."""
    a = t.detach().abs()
    if channel_dim is None:
        amax = a.amax()
    else:
        dims = [d for d in range(t.dim()) if d != channel_dim]
        amax = a.amax(dims, keepdim=True)
    s = amax.clamp_min(1e-30) / 127.0
    q = torch.round(t.detach() / s).clamp(-127, 127) * s
    return t + (q - t).detach()


ROUNDINGS = {
    "fp8": (fp8, fp8, fp8),
    # (input, conv weight [Cout, Cin, ...], transposed weight [Cin, Cout, ...])
    "int8": (int8, lambda w: int8(w, 0), lambda w: int8(w, 1)),
}


def low_net(net, kind="fp8"):
    """A copy of the reference ``net`` whose convolutions run in ``kind``
    (``fp8`` or ``int8``), with the same parameter names; its parameters
    are the copy's own."""
    rx, rw, rwt = ROUNDINGS[kind]

    def conv(c, x):
        return F.conv3d(rx(x), rw(c.weight), c.bias, c.stride, c.padding)

    def deconv(c, x):
        return F.conv_transpose3d(rx(x), rwt(c.weight), c.bias, c.stride)
    out = copy.deepcopy(net)
    for m in out.modules():
        if isinstance(m, nn.ConvTranspose3d):
            m.forward = types.MethodType(deconv, m)
        elif isinstance(m, nn.Conv3d):
            m.forward = types.MethodType(conv, m)
    return out
