"""Operations of a SwinUNETR forward, and its windowed attention's work, from its widths.

:func:`forward_flops` counts one forward of one box: every convolution
(``2 k^3 Cin Cout`` per output voxel; a 2^3 stride-2 transposed conv
feeds each output voxel from one tap, ``2 Cin Cout``), every linear layer
(``2 Cin Cout`` per token) and the windowed attention's two products
(:func:`attention_calls`), on the padded token grids the attention really
computes. Norms, activations, the softmax and the reshapes are left out.

:func:`attention_calls` lists each Swin block's attention call on one box
with its windows, heads, window tokens and whether it is shifted;
:func:`attention_work` gives a call's least operations and bytes on a
batch: ``4 N^2 d`` operations per window and head (``q k^T`` and the
product with ``v``), and ``q``, ``k``, ``v`` and the output read or
written once in bf16 with the additive mask read once (``[heads, N, N]``,
or ``[nW, heads, N, N]`` in a shifted block).
"""
from __future__ import annotations

import math

#: the net's total down-sampling: the patch embedding and four merges
MAX_STRIDE = 32


def _window(grid, window, shifted):
    """The window (clipped to the grid), the padded grid, and whether the
    block rolls (some axis longer than the window)."""
    ws = [min(n, window) for n in grid]
    padded = [-(-n // w) * w for n, w in zip(grid, ws)]
    return ws, padded, shifted and any(n > window for n in grid)


def attention_calls(net: dict, patch_zyx):
    """``[(stage, block, windows, heads, tokens per window, shifted)]`` of
    one box of ``patch_zyx`` voxels."""
    grid = [p // 2 for p in patch_zyx]
    calls = []
    for stage, (depth, heads) in enumerate(zip(net["depths"], net["num_heads"])):
        for block in range(depth):
            ws, padded, shifted = _window(grid, net["window_size"], block % 2 == 1)
            windows = math.prod(p // w for p, w in zip(padded, ws))
            calls.append((stage, block, windows, heads, math.prod(ws), shifted))
        grid = [-(-n // 2) for n in grid]
    return calls


def windows_per_box(net: dict, patch_zyx) -> int:
    """Windows attended by one box's forward, over every block."""
    return sum(c[2] for c in attention_calls(net, patch_zyx))


def attention_work(call, batch, head_dim, elem_bytes=2):
    """``(operations, bytes)`` of one attention call on ``batch`` boxes."""
    _, _, windows, heads, n, shifted = call
    ops = 4.0 * batch * windows * heads * n * n * head_dim
    qkvo = 4.0 * batch * windows * heads * n * head_dim
    mask = (windows if shifted else 1) * heads * n * n
    return ops, elem_bytes * (qkvo + mask)


def forward_flops(net: dict, patch_zyx) -> float:
    """Operations of one forward of one box."""
    f, cin, cls = net["feature_size"], net["in_channels"], net["num_classes"]
    vox = float(math.prod(patch_zyx))
    total = 2.0 * 8 * cin * f * vox / 8                       # patch embedding

    def res(ci, co, v):                                        # residual block
        return 2.0 * v * (27 * ci * co + 27 * co * co + (ci * co if ci != co else 0))

    grid = [p // 2 for p in patch_zyx]
    for stage, (depth, heads) in enumerate(zip(net["depths"], net["num_heads"])):
        c = f * 2 ** stage
        tokens = math.prod(grid)
        for block in range(depth):
            ws, padded, _ = _window(grid, net["window_size"], block % 2 == 1)
            padded_tokens = math.prod(padded)
            total += 2.0 * padded_tokens * c * 3 * c            # qkv (padding included)
            total += 2.0 * padded_tokens * c * c                # output projection
            total += 4.0 * padded_tokens * math.prod(ws) * c    # q k^T and the product with v
            total += 2.0 * tokens * c * 4 * c * 2               # MLP
        grid = [-(-n // 2) for n in grid]
        total += 2.0 * math.prod(grid) * 8 * c * 2 * c          # merge
    # the UNETR conv path: voxels at each level of the 2x pyramid
    level = [vox / 8 ** i for i in range(6)]
    total += res(cin, f, level[0])                             # enc0
    total += res(f, f, level[1]) + res(2 * f, 2 * f, level[2]) + res(4 * f, 4 * f, level[3])
    total += res(16 * f, 16 * f, level[5])                     # dec4 on hidden state 4
    for lvl, (ci, co) in zip((4, 3, 2, 1, 0), ((16 * f, 8 * f), (8 * f, 4 * f),
                                             (4 * f, 2 * f), (2 * f, f), (f, f))):
        total += 2.0 * ci * co * level[lvl] + res(2 * co, co, level[lvl])
    return total + 2.0 * f * cls * vox                         # the 1^3 head
