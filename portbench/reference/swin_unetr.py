"""Plain float32 SwinUNETR, written from the paper and MONAI's description.

SwinUNETR (Hatamizadeh et al. 2022, arXiv:2201.01714; MONAI
``monai/networks/nets/swin_unetr.py``), for the comparison that decides a
cell's ``correct`` and for the CPU tests. One forward of a 96^3 box:

1. Patch embedding: conv 2^3 stride 2 with bias, ``in -> F`` channels.
2. Four stages at 48^3, 24^3, 12^3, 6^3 tokens (F, 2F, 4F, 8F channels),
   each of Swin blocks ``x += WMSA(LN(x))``, ``x += MLP(LN(x))`` (MLP:
   Linear C -> 4C, exact GELU, Linear 4C -> C), then patch merging: the
   eight tokens of each 2^3 group concatenated (8C), LayerNorm, Linear
   8C -> 2C without bias. The five hidden states (the embedding and each
   stage's merged output) each go through a LayerNorm without affine.
3. WMSA: the LayerNorm's output padded with zeros to a multiple of the
   window on each axis; in every second block, rolled by minus half a
   window, pairs of tokens from different shifted regions get -100; the
   grid cut into windows; in each window and head
   ``softmax(q k^T / sqrt(d) + B) v``, then Linear C -> C, the padding
   cropped, the roll undone. ``B[i, j]`` is a learned table of
   ``(2w - 1)^3`` rows per head at the offset of token i from token j.
   An axis no longer than the window is one window and not rolled.
4. UNETR: residual blocks (3^3 conv, InstanceNorm, LeakyReLU 0.01, 3^3
   conv, InstanceNorm, plus a 1^3 conv and InstanceNorm where the widths
   differ; added; LeakyReLU), convs without bias and InstanceNorm without
   affine; ``enc0`` on the input, ``enc1..3`` on hidden states 0..2,
   ``dec4`` on hidden state 4, five up blocks (transposed conv 2^3 stride
   2 without bias, then the skip concatenated, a residual block) with the
   skips hidden state 3, ``enc3``, ``enc2``, ``enc1``, ``enc0``, and a
   1^3 conv with bias to the classes.

Departures from MONAI's code, both as the benchmark's configuration states
them: patch merging takes the eight distinct neighbours in ``(d, h, w)``
order (MONAI's default ``"merging"`` repeats two of them, for its old
weights), and a window clipped to a grid smaller than the configured one
reads the bias table at its own offsets (MONAI slices the full window's
index ``[:n, :n]``). No trained weights are used, so neither costs
anything here.

Everything is computed by hand from the parameters: the LayerNorms,
InstanceNorms, GELU and the attention's ``q k^T``, softmax and ``v`` product
(no fused attention), windows gathered by an index map of the padded grid.
The convolutions and linear layers are ``nn.Conv3d``, ``nn.ConvTranspose3d``
and ``nn.Linear`` modules, so that :func:`low_net` can round them. Tensors
are NCDHW; the parameter names are the program's, so one state dict loads
in both. Nothing here imports the program or JAX; every forward runs with
``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` False.
"""
from __future__ import annotations

import math
import types

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference import lowp
from portbench.reference.nets import exact

EPS = 1e-5


def layer_norm(x, weight=None, bias=None):
    """Over the last axis, biased variance."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    y = (x - mean) / torch.sqrt(var + EPS)
    return y if weight is None else y * weight + bias


def instance_norm(x):
    """Per sample and channel over D, H, W, biased variance; no affine."""
    mean = x.mean((2, 3, 4), keepdim=True)
    var = ((x - mean) ** 2).mean((2, 3, 4), keepdim=True)
    return (x - mean) / torch.sqrt(var + EPS)


def leaky(x):
    return torch.where(x >= 0, x, 0.01 * x)


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def window_map(grid, ws):
    """For the padded ``grid``: the flat grid index of each window slot,
    ``[nW, N]`` (windows and their tokens in ``(d, h, w)`` order), and each
    slot's coordinates inside its window, ``[N, 3]``."""
    def cells(sizes):
        return torch.stack([t.reshape(-1) for t in torch.meshgrid(
            *[torch.arange(n) for n in sizes], indexing="ij")], 1)
    corner = cells([g // w for g, w in zip(grid, ws)]) * torch.tensor(ws)   # [nW, 3]
    slots = cells(ws)                                                       # [N, 3]
    at = corner[:, None, :] + slots[None, :, :]                             # [nW, N, 3]
    return (at[..., 0] * grid[1] + at[..., 1]) * grid[2] + at[..., 2], slots


def region_labels(grid, ws, shift):
    """Per flat index of the rolled padded grid: the shifted region it lies in."""
    per_axis = []
    for n, w, s in zip(grid, ws, shift):
        lab = torch.zeros(n, dtype=torch.long)
        lab[n - w:] = 1
        if s:
            lab[n - s:] = 2
        per_axis.append(lab)
    return (per_axis[0][:, None, None] * 9 + per_axis[1][None, :, None] * 3
            + per_axis[2][None, None, :]).reshape(-1)


class Attention(nn.Module):
    def __init__(self, dim, heads, window):
        super().__init__()
        self.heads, self.window = heads, window
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(math.prod(2 * w - 1 for w in window), heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def bias(self, slots):
        """``[heads, N, N]``: the table's row at each pair's offset."""
        off = slots[:, None, :] - slots[None, :, :] + torch.tensor(self.window) - 1
        spans = [2 * w - 1 for w in self.window]
        row = off[..., 0] * spans[1] * spans[2] + off[..., 1] * spans[2] + off[..., 2]
        return self.relative_position_bias_table[row.to(
            self.relative_position_bias_table.device)].permute(2, 0, 1)

    def forward(self, win, slots, mask):
        """``win [B, nW, N, C]``; ``mask [nW, N, N]`` or None."""
        b, nw, n, c = win.shape
        h, d = self.heads, c // self.heads
        qkv = self.qkv(win).reshape(b, nw, n, 3, h, d)
        q, k, v = (qkv[:, :, :, i].permute(0, 1, 3, 2, 4) for i in range(3))  # [B, nW, h, N, d]
        scores = q @ k.transpose(-1, -2) / math.sqrt(d) + self.bias(slots)
        if mask is not None:
            scores = scores + mask[None, :, None]
        out = torch.softmax(scores, dim=-1) @ v
        return self.proj(out.permute(0, 1, 3, 2, 4).reshape(b, nw, n, c))


class Block(nn.Module):
    def __init__(self, dim, heads, window, shifted):
        super().__init__()
        self.window, self.shifted = window, shifted
        self.norm1 = nn.LayerNorm(dim)
        self.attn = Attention(dim, heads, window)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = nn.Module()
        self.mlp.linear1 = nn.Linear(dim, 4 * dim)
        self.mlp.linear2 = nn.Linear(4 * dim, dim)

    def wmsa(self, x):
        """``x [B, D, H, W, C]`` after the first LayerNorm."""
        b, size, c = x.shape[0], x.shape[1:4], x.shape[4]
        ws = tuple(min(n, w) for n, w in zip(size, self.window))
        shift = tuple(w // 2 if self.shifted and n > w else 0
                      for n, w in zip(size, self.window))
        grid = tuple(-(-n // w) * w for n, w in zip(size, ws))
        padded = x.new_zeros((b,) + grid + (c,))
        padded[:, :size[0], :size[1], :size[2]] = x
        rolled = torch.roll(padded, tuple(-s for s in shift), (1, 2, 3)) if any(shift) else padded
        index, slots = window_map(grid, ws)
        flat = rolled.reshape(b, -1, c)
        win = flat[:, index.reshape(-1).to(x.device)].reshape(b, index.shape[0], index.shape[1], c)
        mask = None
        if any(shift):
            lab = region_labels(grid, ws, shift)[index]
            mask = torch.where(lab[:, :, None] == lab[:, None, :], 0.0, -100.0).to(x.device)
        out = self.attn(win, slots, mask)
        back = torch.empty_like(flat)
        back[:, index.reshape(-1).to(x.device)] = out.reshape(b, -1, c)
        back = back.reshape((b,) + grid + (c,))
        if any(shift):
            back = torch.roll(back, shift, (1, 2, 3))
        return back[:, :size[0], :size[1], :size[2]]

    def forward(self, x):
        x = x + self.wmsa(layer_norm(x, self.norm1.weight, self.norm1.bias))
        y = layer_norm(x, self.norm2.weight, self.norm2.bias)
        return x + self.mlp.linear2(gelu(self.mlp.linear1(y)))


class Merge(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm = nn.LayerNorm(8 * dim)
        self.reduction = nn.Linear(8 * dim, 2 * dim, bias=False)

    def forward(self, x):
        b, d, h, w, c = x.shape
        full = x.new_zeros((b, d + d % 2, h + h % 2, w + w % 2, c))
        full[:, :d, :h, :w] = x
        parts = [full[:, i::2, j::2, k::2] for i in (0, 1) for j in (0, 1) for k in (0, 1)]
        return self.reduction(layer_norm(torch.cat(parts, -1), self.norm.weight, self.norm.bias))


class Stage(nn.Module):
    def __init__(self, dim, depth, heads, window):
        super().__init__()
        self.blocks = nn.ModuleList(Block(dim, heads, window, i % 2 == 1) for i in range(depth))
        self.downsample = Merge(dim)

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return self.downsample(x)


class Encoder(nn.Module):
    def __init__(self, cin, f, depths, heads, window):
        super().__init__()
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv3d(cin, f, 2, stride=2)
        for i in range(4):
            self.add_module(f"layers{i + 1}", nn.ModuleList(
                [Stage(f * 2 ** i, depths[i], heads[i], window)]))

    def forward(self, x):
        t = self.patch_embed.proj(x).permute(0, 2, 3, 4, 1)
        hidden = [layer_norm(t)]
        for i in range(4):
            t = getattr(self, f"layers{i + 1}")[0](t)
            hidden.append(layer_norm(t))
        return [h.permute(0, 4, 1, 2, 3) for h in hidden]


def conv_holder(cin, cout, k, bias=False, transposed=False):
    m = nn.Module()
    m.conv = (nn.ConvTranspose3d(cin, cout, k, stride=k, bias=bias) if transposed
              else nn.Conv3d(cin, cout, k, padding=k // 2, bias=bias))
    return m


class Res(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = conv_holder(cin, cout, 3)
        self.conv2 = conv_holder(cout, cout, 3)
        self.proj = cin != cout
        if self.proj:
            self.conv3 = conv_holder(cin, cout, 1)

    def forward(self, x):
        y = instance_norm(self.conv2.conv(leaky(instance_norm(self.conv1.conv(x)))))
        skip = instance_norm(self.conv3.conv(x)) if self.proj else x
        return leaky(y + skip)


class Up(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.transp_conv = conv_holder(cin, cout, 2, transposed=True)
        self.conv_block = Res(2 * cout, cout)

    def forward(self, x, skip):
        return self.conv_block(torch.cat([self.transp_conv.conv(x), skip], 1))


class SwinUNETR(nn.Module):
    """``x [B, Cin, D, H, W]`` -> class logits ``[B, classes, D, H, W]``;
    :meth:`probs` applies the softmax."""

    def __init__(self, in_channels, classes, feature_size=48, depths=(2, 2, 2, 2),
                 num_heads=(3, 6, 12, 24), window_size=7):
        super().__init__()
        f = feature_size
        self.swinViT = Encoder(in_channels, f, depths, num_heads, (window_size,) * 3)
        self.encoder1 = nn.Module()
        self.encoder1.layer = Res(in_channels, f)
        for name, c in (("encoder2", f), ("encoder3", 2 * f), ("encoder4", 4 * f),
                        ("encoder10", 16 * f)):
            blk = nn.Module()
            blk.layer = Res(c, c)
            self.add_module(name, blk)
        for name, cin, cout in (("decoder5", 16 * f, 8 * f), ("decoder4", 8 * f, 4 * f),
                                ("decoder3", 4 * f, 2 * f), ("decoder2", 2 * f, f),
                                ("decoder1", f, f)):
            self.add_module(name, Up(cin, cout))
        self.out = nn.Module()
        self.out.conv = conv_holder(f, classes, 1, bias=True)

    def forward(self, x):
        with exact():
            hs = self.swinViT(x)
            enc0 = self.encoder1.layer(x)
            enc1 = self.encoder2.layer(hs[0])
            enc2 = self.encoder3.layer(hs[1])
            enc3 = self.encoder4.layer(hs[2])
            dec = self.encoder10.layer(hs[4])
            for up, skip in ((self.decoder5, hs[3]), (self.decoder4, enc3),
                             (self.decoder3, enc2), (self.decoder2, enc1),
                             (self.decoder1, enc0)):
                dec = up(dec, skip)
            return self.out.conv.conv(dec)

    def probs(self, x):
        return torch.softmax(self(x), dim=1)


def build(config: dict) -> SwinUNETR:
    """The reference net of a configuration file's ``net`` entry."""
    n = config["net"]
    return SwinUNETR(n["in_channels"], n["num_classes"], n["feature_size"],
                     n["depths"], n["num_heads"], n["window_size"])


def low_net(net, kind="fp8"):
    """A copy of ``net`` whose convolutions (:func:`lowp.low_net`) and linear
    layers take their input and weight rounded to ``kind`` (``fp8`` or
    ``int8``, weights per output row), computing in float32."""
    rx, rw, _ = lowp.ROUNDINGS[kind]
    out = lowp.low_net(net, kind)

    def linear(m, x):
        return F.linear(rx(x), rw(m.weight), m.bias)
    for m in out.modules():
        if isinstance(m, nn.Linear):
            m.forward = types.MethodType(linear, m)
    return out

