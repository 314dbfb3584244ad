"""The wgmma path's launch plan (``segmentation3d_tpu_torch/ops/conv_plan.py``)
and its shared-memory addressing, on the CPU.

- For every site of both main paths (``chip_smoke.py``'s ``site_list()`` and
  ``site_list_i8()``, batch 8) and every wide shape of
  ``tests/test_torch_port_kernel_cuda.py``: the plan fits in 227 KB of
  shared memory, its boxes cover every output voxel exactly once, its grid
  is the one planned, and the main path's sites launch at least one block
  per SM.
- A numpy emulation of the kernel's addressing reproduces the conv: the
  halo is built as the TMA loads build it (two 16-byte channel planes,
  zeros outside the volume), each tap's A tile is read through
  ``base + tap offset`` with the descriptor's LBO and SBO, and multiplied by
  the B tile of the K-major packed weights. In float64 it equals
  ``thin_conv3d_reference`` at float32 rounding; in int64 it equals
  ``window_conv_i8_reference`` exactly.
"""
import math
import os
import re
import sys

import numpy as np
import pytest
import torch

from segmentation3d_tpu_torch.ops import conv_plan as cp
from segmentation3d_tpu_torch.ops.thin_conv import thin_conv3d_reference
from segmentation3d_tpu_torch.ops.window_i8 import window_conv_i8_reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (imports only the standard library at top level)

CUDA_SHAPE = (2, 6, 10, 12)


def block_origin(plan, bid):
    """(b, z0, y0, x0) of block ``blockIdx.x = bid``, decoded as the kernel
    decodes it (``conv_wgmma.cuh``: x boxes fastest, then y, z, batch)."""
    bx = bid % plan.nbx
    t = bid // plan.nbx
    by = t % plan.nby
    t //= plan.nby
    bz = t % plan.nbz
    return t // plan.nbz, bz * plan.mt, by * cp.BOX_Y, bx * cp.BOX_X


def _sites():
    """(B, D, H, W, cin, cout, elem_bytes, main_path) of every wide site."""
    b = chip_smoke.BATCH
    out = [(b, s, s, s, ci, co, 2, True)
           for _, s, ci, co, _, _ in chip_smoke.site_list() if ci % 32 == 0]
    out += [(b, s, s, s, ci, co, 1, True)
            for _, s, ci, co, _, _, _ in chip_smoke.site_list_i8()]
    for eb in (2, 1):
        out += [(b, *chip_smoke.RAGGED_SHAPE, 32, 32, eb, False)]
        out += [(*CUDA_SHAPE, ci, co, eb, False)
                for ci, co in ((32, 2), (32, 32), (64, 64), (128, 64), (256, 256),
                               (96, 96), (64, 128))]
        out += [(2, 5, 9, w, 32, 2, eb, False) for w in (7, 13)]
    return out


@pytest.mark.parametrize("site", _sites(), ids=lambda s: "x".join(map(str, s[:7])))
def test_plan_fits_covers_and_grids(site):
    B, D, H, W, cin, cout, eb, main = site
    p = cp.plan_conv(B, D, H, W, cin, cout, eb)
    assert p.smem_bytes <= cp.MAX_SMEM == 227 * 1024
    assert (p.stages * (p.stage_bytes + cp.BARRIER_BYTES) + cp.TAP_BYTES + cp.ALIGN
            == p.smem_bytes)
    assert p.plane_bytes % 128 == 0 and p.stage_bytes % 128 == 0
    assert p.tx_bytes == 2 * 10 * 10 * (p.mt + 2) * 16 + 27 * p.bn * 32
    assert p.ks * 32 == cin * eb and p.mt in cp.MT_CHOICES[p.bn]
    assert p.bn * p.mt <= 256  # at most 128 accumulator registers a thread
    # the grid: N blocks cover cout, boxes tile each axis with no spare box
    assert p.grid_y == p.nblk == math.ceil(cout / p.bn)
    for n, extent, size in ((p.nbx, 8, W), (p.nby, 8, H), (p.nbz, p.mt, D)):
        assert (n - 1) * extent < size <= n * extent
    assert p.grid_x == B * p.nbz * p.nby * p.nbx
    origins = {block_origin(p, i) for i in range(p.grid_x)}
    assert len(origins) == p.grid_x  # no box twice
    # every voxel exactly once: boxes at distinct origins on the box grid
    assert origins == {(b, z * p.mt, y * 8, x * 8) for b in range(B)
                       for z in range(p.nbz) for y in range(p.nby)
                       for x in range(p.nbx)}
    if main:
        assert p.blocks >= cp.SMS
    arr = p.as_array()
    assert arr.dtype == np.int32 and arr.shape == (cp.PLAN_LEN,)


def test_plan_fields_match_the_kernel_header():
    """The plan array's order is the header's enum of indices."""
    path = os.path.join(ROOT, "segmentation3d_tpu_torch", "csrc", "conv_wgmma.cuh")
    with open(path) as f:
        enum = re.search(r"enum \{\s*(P_BN.*?)P_TAP0", f.read(), re.S).group(1)
    names = [n.strip() for n in enum.split(",") if n.strip()]
    assert names == ["P_" + f.upper() for f in cp.PLAN_FIELDS]


def test_plan_instances_match_the_kernel_header():
    """Every (bn, mt) the plan may choose has a kernel instance."""
    path = os.path.join(ROOT, "segmentation3d_tpu_torch", "csrc", "conv_wgmma.cuh")
    with open(path) as f:
        cases = re.findall(r"CONVWG_CASE\((\d+), (\d+)\)", f.read())
    assert sorted((int(n), int(m)) for n, m in cases) == sorted(
        (bn, mt) for bn, mts in cp.MT_CHOICES.items() for mt in mts)


def _emulate(x, w, p):
    """The kernel's wgmma path in numpy: returns the conv sums
    [B, D, H, W, cout] (x, w as float64 or int64 values) and how often each
    output was written."""
    B, D, H, W, cin = x.shape
    t = cp.CHUNK // p.elem_bytes
    wp = cp.pack_weights(torch.from_numpy(w), p).numpy()
    cpp = p.plane_bytes // 16  # 16-byte cells a halo plane
    xpad = np.pad(x, ((0, 0), (1, p.nbz * p.mt + 1 - D), (1, p.nby * 8 + 1 - H),
                      (1, p.nbx * 8 + 1 - W), (0, 0)))
    rows = np.arange(64)
    a_rows = (rows // 8) * (p.sbo_a // 16) + rows % 8
    n = np.arange(p.bn)
    b_rows = (n // 8) * (p.sbo_b // 16) + n % 8
    out = np.zeros((B, D, H, W, p.nblk * p.bn), x.dtype)
    hits = np.zeros(out.shape, np.int64)
    for nb in range(p.grid_y):
        for bid in range(p.grid_x):
            b, z0, y0, x0 = block_origin(p, bid)
            acc = np.zeros((p.mt, 64, p.bn), x.dtype)
            for ks in range(p.ks):
                halo = np.zeros((2 * cpp, t), x.dtype)
                for c in range(2):
                    ch = (ks * 32 + c * 16) // p.elem_bytes
                    box = xpad[b, z0:z0 + p.zh, y0:y0 + p.yh, x0:x0 + p.xh, ch:ch + t]
                    halo[c * cpp:c * cpp + box.size // t] = box.reshape(-1, t)
                wcells = wp[nb, ks].reshape(-1, t)  # [27 * 2 * bn, t]
                for tap in range(27):
                    bb = tap * 2 * p.bn
                    btile = np.concatenate(
                        [wcells[bb + b_rows + kc * (p.lbo_b // 16)] for kc in (0, 1)], 1)
                    for j in range(p.mt):
                        ab = (p.taps[tap] + j * p.tile_a) // 16
                        atile = np.concatenate(
                            [halo[ab + a_rows + kc * (p.lbo_a // 16)] for kc in (0, 1)], 1)
                        acc[j] += atile @ btile.T
            for j in range(p.mt):
                for r in range(64):
                    z, y, xx = z0 + j, y0 + r // 8, x0 + r % 8
                    if z < D and y < H and xx < W:
                        out[b, z, y, xx, nb * p.bn:(nb + 1) * p.bn] = acc[j, r]
                        hits[b, z, y, xx, nb * p.bn:(nb + 1) * p.bn] += 1
    cout = w.shape[-1]
    return out[..., :cout], hits[..., :cout]


EMU_SHAPES = [((2, 5, 7, 11), 32, 32), ((1, 6, 6, 6), 64, 2), ((1, 3, 10, 12), 96, 64)]


@pytest.mark.parametrize("shape,cin,cout", EMU_SHAPES)
def test_emulated_bf16_addressing_matches_reference(shape, cin, cout):
    rng = np.random.default_rng(cin + cout)
    x = torch.from_numpy(rng.normal(size=shape + (cin,)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(3, 3, 3, cin, cout))
                          / np.sqrt(27 * cin)).astype(np.float32))
    xb = x.to(torch.bfloat16).double().numpy()
    wb = w.to(torch.bfloat16).double().numpy()
    p = cp.plan_conv(*shape, cin, cout, 2)
    got, hits = _emulate(xb, wb, p)
    assert (hits == 1).all()
    ref = thin_conv3d_reference(x, w, None, out_dtype=torch.float32).double().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("shape,cin,cout", EMU_SHAPES)
def test_emulated_int8_addressing_matches_reference_exactly(shape, cin, cout):
    rng = np.random.default_rng(cin * 7 + cout)
    x = rng.integers(-127, 128, shape + (cin,)).astype(np.int8)
    w = rng.integers(-127, 128, (3, 3, 3, cin, cout)).astype(np.int8)
    p = cp.plan_conv(*shape, cin, cout, 1)
    got, hits = _emulate(x.astype(np.int64), w.astype(np.int64), p)
    assert (hits == 1).all()
    ones, zeros = torch.ones(cout), torch.zeros(cout)
    ref = window_conv_i8_reference(torch.from_numpy(x), torch.from_numpy(w), ones,
                                   zeros, "none", out="f32").numpy()
    assert np.abs(got).max() < 2 ** 31
    np.testing.assert_array_equal(got.astype(np.float32), ref)


def test_pack_weights_layout():
    """[nblk, ks, 27, 2, bn, T]: element (tap, ci, co) sits at block co // bn,
    slice ci // (2T), chunk (ci // T) % 2, row co % bn, lane ci % T; padded
    channels are zero."""
    cin, cout = 64, 40
    w = torch.arange(27 * cin * cout, dtype=torch.int32).reshape(3, 3, 3, cin, cout)
    p = cp.plan_conv(1, 4, 4, 4, cin, cout, 2)
    t = 8
    wp = cp.pack_weights(w, p)
    assert tuple(wp.shape) == (p.nblk, p.ks, 27, 2, p.bn, t) == (2, 4, 27, 2, 32, 8)
    flat = w.reshape(27, cin, cout)
    for tap, ci, co in ((0, 0, 0), (13, 17, 33), (26, 63, 39), (5, 8, 31)):
        got = wp[co // p.bn, ci // (2 * t), tap, (ci // t) % 2, co % p.bn, ci % t]
        assert got == flat[tap, ci, co]
    assert (wp[1, :, :, :, cout - p.bn:] == 0).all()


def test_plan_refuses_a_direct_site():
    with pytest.raises(ValueError):
        cp.plan_conv(1, 4, 4, 4, 24, 8, 2)
