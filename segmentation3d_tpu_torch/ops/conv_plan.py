"""Launch geometry of the wgmma path of the two 3x3x3 conv kernels
(``csrc/conv_wgmma.cuh``, instantiated by ``csrc/thin_conv3d.cu`` for bf16
and ``csrc/window_conv_i8.cu`` for int8), planned here so that the CPU tests
check the same numbers that the kernel uses.

A block computes an output box of 8 (x) x 8 (y) x ``mt`` (z) voxels for
``bn`` output channels; each z plane of the box is one 64-row wgmma tile.
K runs over 32-byte slices of the input channels (``ks`` of them) and, in
each slice, over the 27 taps. Per slice the block holds the box's halo,
``10 x 10 x (mt + 2)`` voxels, as two 16-byte channel planes
``[chunk][z][y][x][16 B]`` (zeros outside the volume) and the slice's
weights for its ``bn`` channels, ``[27][chunk][bn][16 B]``. A tap is a byte
offset into the halo; the wgmma descriptors' LBO is the step to the next
16-byte K chunk and their SBO the step to the next 8 rows.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

SMS = 132             # streaming multiprocessors of an H100 SXM
MAX_SMEM = 232448     # dynamic shared memory a block may use on sm_90
BOX_X = BOX_Y = 8     # a 64-row wgmma tile is 8 x 8 voxels of one z plane
CHUNK = 16            # bytes of channels per core-matrix row
SLICE = 32            # bytes of channels per K slice (one wgmma k-step)
MAX_STAGES = 3
DEEP_GRID = 4         # blocks per SM above which the ring has one stage
BARRIER_BYTES = 16    # a full and an empty mbarrier per stage
TAP_BYTES = 27 * 4    # the tap offsets, after the barriers
ALIGN = 128           # TMA destinations are 128-byte aligned

#: box depths (z planes, one 64-row wgmma tile each) the kernel is built
#: for, by N block width, deepest first (``conv_wgmma.cuh``: CONVWG_CASE)
MT_CHOICES = {8: (8, 1), 32: (4, 1), 64: (4, 2, 1)}

#: the plan array's fields, in the order the kernel reads them
#: (``csrc/conv_wgmma.cuh``: ``P_BN`` .. ``P_TAP0``)
PLAN_FIELDS = ("bn", "mt", "nbx", "nby", "nbz", "nblk", "ks", "xh", "yh", "zh",
               "plane_bytes", "w_stage_bytes", "stage_bytes", "stages",
               "tx_bytes", "smem_bytes", "lbo_a", "sbo_a", "lbo_b", "sbo_b",
               "tile_a", "grid_x", "grid_y")
PLAN_LEN = len(PLAN_FIELDS) + 27


def uses_tensor_cores(cin: int, cout: int) -> bool:
    """The wgmma path takes every site with ``cin % 32 == 0``; the direct
    path the rest (the stem, small test shapes)."""
    return cin % 32 == 0 and cout >= 1


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """One site's wgmma launch: shape, tiling, ring and descriptors (bytes)."""
    B: int
    D: int
    H: int
    W: int
    cin: int
    cout: int
    elem_bytes: int
    bn: int
    mt: int
    nbx: int
    nby: int
    nbz: int
    nblk: int
    ks: int
    xh: int
    yh: int
    zh: int
    plane_bytes: int
    w_stage_bytes: int
    stage_bytes: int
    stages: int
    tx_bytes: int
    smem_bytes: int
    lbo_a: int
    sbo_a: int
    lbo_b: int
    sbo_b: int
    tile_a: int
    grid_x: int
    grid_y: int
    taps: tuple  # 27 byte offsets of the taps (dz, dy, dx) into the halo

    @property
    def blocks(self) -> int:
        return self.grid_x * self.grid_y

    @property
    def box(self) -> tuple:
        """(x, y, z) extents of a block's output box."""
        return (BOX_X, BOX_Y, self.mt)

    def as_array(self) -> np.ndarray:
        """The int32 array the kernel's launch reads."""
        return np.array([getattr(self, f) for f in PLAN_FIELDS] + list(self.taps),
                        np.int32)

    def summary(self) -> dict:
        return dict(box=list(self.box), bn=self.bn, nblk=self.nblk,
                    stages=self.stages, smem_bytes=self.smem_bytes,
                    blocks=self.blocks)


def _blocks(B, D, nbx, nby, mt, nblk):
    return B * math.ceil(D / mt) * nby * nbx * nblk


@functools.lru_cache(maxsize=256)
def plan_conv(B: int, D: int, H: int, W: int, cin: int, cout: int,
              elem_bytes: int, mt: int | None = None,
              max_stages: int | None = None) -> ConvPlan:
    """Plan the wgmma launch of one ``[B, D, H, W, cin] -> cout`` site with
    ``elem_bytes`` per operand (2 for bf16, 1 for int8).

    ``bn`` is 8 for a head of up to 8 channels, 64 where cout is a multiple
    of 64 and 32 otherwise (N padded with zeros). ``mt`` (z planes per box)
    is the largest of ``MT_CHOICES[bn]`` (at most 128 accumulator registers
    a thread) that still gives two blocks per SM, else 1; a site with
    fewer than one block per SM at ``bn`` = 64 splits N finer.

    The ring has one stage where the grid has at least ``DEEP_GRID`` blocks
    per SM: several blocks then share an SM and one's copies run under
    another's MMAs, which beat a deeper ring with fewer blocks resident at
    every such site (``tools/plan_sweep.py``); else up to ``MAX_STAGES``,
    as many as fit in shared memory. ``mt`` and ``max_stages`` override the
    choice (for tuning runs)."""
    cbytes = cin * elem_bytes
    if not uses_tensor_cores(cin, cout) or cbytes % SLICE:
        raise ValueError(f"site {cin} -> {cout} does not take the wgmma path")
    nbx, nby = math.ceil(W / BOX_X), math.ceil(H / BOX_Y)
    bn = 8 if cout <= 8 else 64 if cout % 64 == 0 else 32

    def pick(bn):
        nblk = math.ceil(cout / bn)
        for mt in MT_CHOICES[bn]:
            if _blocks(B, D, nbx, nby, mt, nblk) >= 2 * SMS:
                return nblk, mt
        return nblk, 1

    forced, (nblk, mt) = mt, pick(bn)
    if bn == 64 and _blocks(B, D, nbx, nby, mt, nblk) < SMS:
        bn = 32
        nblk, mt = pick(bn)
    if forced is not None:
        if forced not in MT_CHOICES[bn]:
            raise ValueError(f"no kernel instance for bn {bn}, mt {forced}")
        mt = forced
    xh, yh, zh = BOX_X + 2, BOX_Y + 2, mt + 2
    halo = xh * yh * zh * CHUNK
    plane = _round_up(halo, ALIGN)
    w_stage = 27 * bn * SLICE
    stage = _round_up(2 * plane + w_stage, ALIGN)
    ks = cbytes // SLICE
    nbz = math.ceil(D / mt)
    if max_stages is None:
        deep = B * nbz * nby * nbx * nblk >= DEEP_GRID * SMS
        max_stages = 1 if deep else MAX_STAGES
    stages = min(max_stages, ks)
    while stages > 1 and stages * (stage + BARRIER_BYTES) + TAP_BYTES + ALIGN > MAX_SMEM:
        stages -= 1
    smem = stages * (stage + BARRIER_BYTES) + TAP_BYTES + ALIGN
    if smem > MAX_SMEM:
        raise ValueError(f"site {cin} -> {cout} needs {smem} bytes of shared memory")
    taps = tuple(((dz * yh + dy) * xh + dx) * CHUNK
                 for dz in range(3) for dy in range(3) for dx in range(3))
    return ConvPlan(
        B=B, D=D, H=H, W=W, cin=cin, cout=cout, elem_bytes=elem_bytes,
        bn=bn, mt=mt, nbx=nbx, nby=nby, nbz=nbz, nblk=nblk, ks=ks,
        xh=xh, yh=yh, zh=zh, plane_bytes=plane, w_stage_bytes=w_stage,
        stage_bytes=stage, stages=stages, tx_bytes=2 * halo + w_stage,
        smem_bytes=smem, lbo_a=plane, sbo_a=xh * CHUNK, lbo_b=bn * CHUNK,
        sbo_b=8 * CHUNK, tile_a=yh * xh * CHUNK,
        grid_x=B * nbz * nby * nbx, grid_y=nblk, taps=taps)


def pack_weights(w: torch.Tensor, plan: ConvPlan) -> torch.Tensor:
    """``w [3, 3, 3, cin, cout]`` repacked K-major for the kernel:
    ``[nblk, ks, 27, 2, bn, T]`` with ``T`` = 16 bytes of input channels
    (8 bf16 or 16 int8) and cout padded with zeros to ``nblk * bn``."""
    t = CHUNK // plan.elem_bytes
    npad = plan.nblk * plan.bn
    w = w.reshape(27, plan.cin, plan.cout)
    if npad != plan.cout:
        w = torch.nn.functional.pad(w, (0, npad - plan.cout))
    w = w.reshape(27, plan.ks, 2, t, plan.nblk, plan.bn)
    return w.permute(4, 1, 0, 2, 5, 3).contiguous()
