"""SwinUNETR (Hatamizadeh et al. 2022, arXiv:2201.01714) as a PyTorch ``nn.Module``.

A shifted-window 3D Swin Transformer encoder with the UNETR conv decoder,
after MONAI's ``monai.networks.nets.SwinUNETR`` (``feature_size`` 48,
depths (2, 2, 2, 2), heads (3, 6, 12, 24), window 7 at BTCV):

- patch embedding: a 2^3 stride-2 conv with bias to ``feature_size``;
- four stages, each of Swin blocks ``x + WMSA(LN(x))``, ``x + MLP(LN(x))``
  (MLP: Linear C -> 4C, exact GELU, Linear 4C -> C) followed by patch
  merging (the 8 tokens of each 2^3 group concatenated, LayerNorm, Linear
  8C -> 2C without bias), so the five hidden states are the embedding and
  each stage's merged output, each through a LayerNorm without affine;
- windowed attention: the token grid padded with zeros to a multiple of
  the window, every second block rolled by minus half a window with pairs
  of different shifted regions masked by -100, windows of up to 7^3
  tokens, ``softmax(q k^T / sqrt(d) + B) v`` with a learned
  relative-position bias ``B``; an axis no longer than the window is one
  window and never shifted;
- the UNETR conv path: residual blocks (3^3 conv, InstanceNorm, LeakyReLU
  0.01, 3^3 conv, InstanceNorm, plus a 1^3 conv and InstanceNorm where the
  widths differ, added, LeakyReLU; convs without bias, InstanceNorm
  without affine, as MONAI's ``norm_name="instance"``), 2^3 stride-2
  transposed convs without bias, a 1^3 conv with bias to the classes.

Two departures from MONAI's code: patch merging concatenates the eight
distinct neighbours in ``(d, h, w)`` order (MONAI's ``"mergingv2"``; its
default ``"merging"`` repeats two of them for its old weights), and a
window clipped below the configured size reads the bias table at its own
offsets (MONAI slices the full window's index ``[:n, :n]``). Parameter
names are MONAI's, except that no ``relative_position_index`` is stored.

Public layout is channels-last, as the other nets: ``forward`` takes
``[B, D, H, W, in_channels]`` (each of D, H, W divisible by
:func:`max_stride`) and returns per-class probabilities
``[B, D, H, W, out_channels]`` in float32. Under ``torch.autocast`` the
linear layers, convs and attention run in bf16, LayerNorm and the softmax
in float32, InstanceNorm on the bf16 maps with float32 statistics. The
attention goes through ``F.scaled_dot_product_attention`` with the bias
(and, in a shifted block, the mask) as an additive mask, built once per
window shape while no gradient is taken. Each block's attention call is a
:mod:`..utils.tracing` span ``swin.window_attention`` and counts the
windows it attends in ``swin.windows``; the encoder is the span
``swin.encoder``.

Training is not supported: ``seg_train`` refuses this net.
"""
from __future__ import annotations

import itertools
import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from segmentation3d_tpu_torch.utils import tracing

#: the score added to a pair of tokens from different shifted regions
MASK_VALUE = -100.0

#: ``seg_train`` builds only V-Net's keys: this net runs for inference only
TRAINABLE = False


def max_stride() -> int:
    """Total down-sampling factor: the patch embedding and four merges."""
    return 32


def window_and_shift(grid, window, shift):
    """Per axis: the window, clipped to the grid, and the shift, none where
    the window was clipped."""
    ws, ss = [], []
    for n, w, s in zip(grid, window, shift):
        ws.append(min(n, w))
        ss.append(0 if n <= w else s)
    return tuple(ws), tuple(ss)


def partition(x, ws):
    """``[B, D, H, W, C]`` -> windows ``[B, nW, N, C]``, windows in
    ``(d, h, w)`` order, tokens in ``(d, h, w)`` order inside each."""
    b, d, h, w, c = x.shape
    x = x.view(b, d // ws[0], ws[0], h // ws[1], ws[1], w // ws[2], ws[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(b, -1, math.prod(ws), c)


def reverse(windows, ws, grid):
    """The inverse of :func:`partition` onto the grid ``(D, H, W)``."""
    b, c = windows.shape[0], windows.shape[-1]
    d, h, w = grid
    x = windows.view(b, d // ws[0], h // ws[1], w // ws[2], ws[0], ws[1], ws[2], c)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, c)


def relative_index(ws, window):
    """``[N, N]`` rows of the bias table (sized for ``window``) for each
    pair of the ``ws`` window's tokens, by their offset."""
    coords = torch.stack(torch.meshgrid(*[torch.arange(n) for n in ws], indexing="ij"))
    rel = coords.flatten(1)[:, :, None] - coords.flatten(1)[:, None, :]
    spans = [2 * w - 1 for w in window]
    strides = (spans[1] * spans[2], spans[2], 1)
    return sum((rel[i] + window[i] - 1) * strides[i] for i in range(3))


def region_mask(grid, ws, ss):
    """``[nW, N, N]``: 0 for pairs of one shifted region, :data:`MASK_VALUE`
    for the others, on the padded ``grid`` rolled by ``-ss``."""
    labels = []
    for n, w, s in zip(grid, ws, ss):
        i = torch.arange(n)
        labels.append((i >= n - w).long() + ((i >= n - s).long() if s else 0))
    lab = labels[0][:, None, None] * 9 + labels[1][None, :, None] * 3 + labels[2][None, None, :]
    win = partition(lab[None, ..., None], ws)[0, :, :, 0]
    return torch.where(win[:, :, None] == win[:, None, :], 0.0, MASK_VALUE)


class WindowAttention(nn.Module):
    """Multi-head self-attention inside windows with a relative-position
    bias table of ``(2 w - 1)^3`` rows, one column per head."""

    def __init__(self, dim, num_heads, window):
        super().__init__()
        self.num_heads, self.window = num_heads, tuple(window)
        rows = math.prod(2 * w - 1 for w in self.window)
        self.relative_position_bias_table = nn.Parameter(torch.zeros(rows, num_heads))
        self.qkv = nn.Linear(dim, 3 * dim, bias=True)
        self.proj = nn.Linear(dim, dim)
        self._masks = {}

    def additive_mask(self, ws, ss, grid, dtype, device):
        """The bias (``[1, heads, N, N]``) or, shifted, the bias plus the
        region mask (``[1, nW * heads, N, N]``), in ``dtype``. Kept per window
        shape while no gradient is taken; its rows padded to 16 elements, so
        an attention kernel reads it without a copy."""
        key = (ws, ss, grid, dtype, device, self.relative_position_bias_table._version)
        if key in self._masks:
            return self._masks[key]
        n = math.prod(ws)
        idx = relative_index(ws, self.window).to(device)
        bias = self.relative_position_bias_table[idx.reshape(-1)].view(n, n, -1)
        bias = bias.permute(2, 0, 1)[None].to(dtype)                     # [1, h, N, N]
        if any(ss):
            mask = region_mask(grid, ws, ss).to(device=device, dtype=dtype)  # [nW, N, N]
            bias = (bias + mask[:, None]).reshape(1, -1, n, n)           # [1, nW*h, N, N]
        if torch.is_grad_enabled():
            return bias
        padded = bias.new_zeros(bias.shape[:-1] + (-(-n // 16) * 16,))
        padded[..., :n] = bias
        self._masks = {k: v for k, v in self._masks.items() if k[-1] == key[-1]}
        self._masks[key] = padded[..., :n]
        return self._masks[key]

    def forward(self, windows, ws, ss, grid):
        """``windows [B, nW, N, C]`` of the padded, rolled ``grid``."""
        b, nw, n, c = windows.shape
        h = self.num_heads
        qkv = self.qkv(windows).view(b, nw, n, 3, h, c // h).permute(3, 0, 1, 4, 2, 5)
        mask = self.additive_mask(ws, ss, grid, qkv.dtype, qkv.device)
        # shifted: the windows in the heads' place, so that the mask of
        # every window broadcasts over the batch; otherwise over the windows
        shape = (b, nw * h, n, c // h) if any(ss) else (b * nw, h, n, c // h)
        q, k, v = (t.reshape(shape) for t in qkv)
        with tracing.span("swin.window_attention"):
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        tracing.count("swin.windows", b * nw)
        out = out.view(b, nw, h, n, c // h).transpose(2, 3).reshape(b, nw, n, c)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.linear1 = nn.Linear(dim, hidden)
        self.linear2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.linear2(F.gelu(self.linear1(x)))


class SwinBlock(nn.Module):
    """``x + WMSA(LN(x))``, then ``x + MLP(LN(x))``, on ``[B, D, H, W, C]``."""

    def __init__(self, dim, num_heads, window, shift, mlp_ratio=4.0):
        super().__init__()
        self.window, self.shift = tuple(window), tuple(shift)
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, window)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def _attend(self, x):
        b, d, h, w, c = x.shape
        ws, ss = window_and_shift((d, h, w), self.window, self.shift)
        pads = [-n % k for n, k in zip((d, h, w), ws)]
        if any(pads):
            x = F.pad(x, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        grid = tuple(x.shape[1:4])
        if any(ss):
            x = torch.roll(x, shifts=tuple(-s for s in ss), dims=(1, 2, 3))
        x = reverse(self.attn(partition(x, ws), ws, ss, grid), ws, grid)
        if any(ss):
            x = torch.roll(x, shifts=ss, dims=(1, 2, 3))
        return x[:, :d, :h, :w] if any(pads) else x

    def forward(self, x):
        x = x + self._attend(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """The 8 tokens of each 2^3 group, concatenated in ``(d, h, w)`` order,
    LayerNorm, Linear 8C -> 2C without bias; odd sizes padded with zeros."""

    def __init__(self, dim):
        super().__init__()
        self.norm = nn.LayerNorm(8 * dim)
        self.reduction = nn.Linear(8 * dim, 2 * dim, bias=False)

    def forward(self, x):
        d, h, w = x.shape[1:4]
        if d % 2 or h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
        x = torch.cat([x[:, i::2, j::2, k::2] for i, j, k in
                       itertools.product(range(2), repeat=3)], dim=-1)
        return self.reduction(self.norm(x))


class Stage(nn.Module):
    """MONAI's ``BasicLayer``: Swin blocks, every second one shifted, then
    patch merging."""

    def __init__(self, dim, depth, num_heads, window, mlp_ratio):
        super().__init__()
        half = tuple(w // 2 for w in window)
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window, (0, 0, 0) if i % 2 == 0 else half, mlp_ratio)
            for i in range(depth))
        self.downsample = PatchMerging(dim)

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return self.downsample(x)


class SwinTransformer(nn.Module):
    """The encoder: ``x [B, Cin, D, H, W]`` -> the five hidden states,
    channels-last, each through a LayerNorm without affine."""

    def __init__(self, in_channels, dim, depths, num_heads, window, patch=2,
                 mlp_ratio=4.0):
        super().__init__()
        self.patch_embed = _named(proj=nn.Conv3d(in_channels, dim, patch, stride=patch))
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            self.add_module(f"layers{i + 1}", nn.ModuleList(
                [Stage(dim * 2 ** i, depth, heads, window, mlp_ratio)]))
        self.num_stages = len(depths)

    def forward(self, x):
        with tracing.span("swin.encoder"):
            x = self.patch_embed.proj(x).permute(0, 2, 3, 4, 1)
            hidden = [F.layer_norm(x, x.shape[-1:])]
            for i in range(self.num_stages):
                x = getattr(self, f"layers{i + 1}")[0](x)
                hidden.append(F.layer_norm(x, x.shape[-1:]))
        return hidden


def _named(**children):
    """A module that only holds ``children``, under MONAI's names."""
    m = nn.Module()
    for name, child in children.items():
        setattr(m, name, child)
    return m


def _conv(cin, cout, k, bias=False, transposed=False):
    """A conv under the attribute ``conv``, as MONAI's ``Convolution`` names it."""
    if transposed:
        return _named(conv=nn.ConvTranspose3d(cin, cout, k, stride=k, bias=bias))
    return _named(conv=nn.Conv3d(cin, cout, k, padding=k // 2, bias=bias))


def _norm_act(x, act=True):
    x = F.instance_norm(x, eps=1e-5)
    return F.leaky_relu(x, 0.01) if act else x


class ResBlock(nn.Module):
    """MONAI's ``UnetResBlock`` with 3^3 kernels and stride 1."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = _conv(cin, cout, 3)
        self.conv2 = _conv(cout, cout, 3)
        if cin != cout:
            self.conv3 = _conv(cin, cout, 1)

    def forward(self, x):
        y = _norm_act(self.conv2.conv(_norm_act(self.conv1.conv(x))), act=False)
        r = _norm_act(self.conv3.conv(x), act=False) if hasattr(self, "conv3") else x
        return F.leaky_relu(y + r, 0.01)


class UpBlock(nn.Module):
    """MONAI's ``UnetrUpBlock``: 2^3 stride-2 transposed conv, the skip
    concatenated after it, a residual block."""

    def __init__(self, cin, cout):
        super().__init__()
        self.transp_conv = _conv(cin, cout, 2, transposed=True)
        self.conv_block = ResBlock(2 * cout, cout)

    def forward(self, x, skip):
        return self.conv_block(torch.cat([self.transp_conv.conv(x), skip], dim=1))


class SegmentationNet(nn.Module):
    """SwinUNETR. D/H/W of the input must be divisible by :func:`max_stride`."""

    def __init__(self, in_channels: int, out_channels: int, feature_size: int = 48,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, mlp_ratio: float = 4.0):
        super().__init__()
        if len(depths) != 4 or len(num_heads) != 4:
            raise ValueError("SwinUNETR has four stages: depths and num_heads "
                             f"of length 4, not {list(depths)}, {list(num_heads)}")
        self.in_channels, self.out_channels = int(in_channels), int(out_channels)
        self.feature_size = f = int(feature_size)
        self.depths = tuple(int(n) for n in depths)
        self.num_heads = tuple(int(n) for n in num_heads)
        self.window_size = int(window_size)
        self.swinViT = SwinTransformer(self.in_channels, f, self.depths, self.num_heads,
                                       (self.window_size,) * 3, mlp_ratio=mlp_ratio)
        # MONAI's UnetrBasicBlock: a residual block under ``layer``
        self.encoder1 = _named(layer=ResBlock(self.in_channels, f))
        self.encoder2 = _named(layer=ResBlock(f, f))
        self.encoder3 = _named(layer=ResBlock(2 * f, 2 * f))
        self.encoder4 = _named(layer=ResBlock(4 * f, 4 * f))
        self.encoder10 = _named(layer=ResBlock(16 * f, 16 * f))
        self.decoder5 = UpBlock(16 * f, 8 * f)
        self.decoder4 = UpBlock(8 * f, 4 * f)
        self.decoder3 = UpBlock(4 * f, 2 * f)
        self.decoder2 = UpBlock(2 * f, f)
        self.decoder1 = UpBlock(f, f)
        self.out = _named(conv=_conv(f, self.out_channels, 1, bias=True))

    #: no BN-folded or int8 form (:func:`..core.seg_infer.build_forward`)
    foldable = False

    def max_stride(self) -> int:
        return max_stride()

    def forward(self, x, return_logits: bool = False):
        """``x [B, D, H, W, in_channels]`` -> ``[B, D, H, W, out_channels]``."""
        if x.shape[-1] != self.in_channels:
            raise ValueError(f"expected {self.in_channels} input channels, "
                             f"got {tuple(x.shape)}")
        x = x.permute(0, 4, 1, 2, 3)
        hidden = [h.permute(0, 4, 1, 2, 3) for h in self.swinViT(x)]
        enc0 = self.encoder1.layer(x)
        enc1 = self.encoder2.layer(hidden[0])
        enc2 = self.encoder3.layer(hidden[1])
        enc3 = self.encoder4.layer(hidden[2])
        dec = self.encoder10.layer(hidden[4])
        dec = self.decoder5(dec, hidden[3])
        dec = self.decoder4(dec, enc3)
        dec = self.decoder3(dec, enc2)
        dec = self.decoder2(dec, enc1)
        logits = self.out.conv.conv(self.decoder1(dec, enc0))
        if logits.dtype != torch.float64:
            logits = logits.float()
        out = logits if return_logits else torch.softmax(logits, dim=1)
        return out.permute(0, 2, 3, 4, 1)
