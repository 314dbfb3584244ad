"""Sliding-window inference: batched patches, blending on the device.

The port of ``segmentation3d_tpu/core/infer_engine.py``
(``make_weight_map``, ``tta_axes``, ``tta_flip_combos``,
``SlidingWindowInferer`` with its test-time flips and on-device ``dice``):
patches are gathered from the device-resident normalized volume and
forwarded in batches; per-class probabilities are pasted into float32
``prob``/``wsum`` accumulators with a per-patch weight map (Gaussian or
constant), divided by ``max(wsum, 1e-8)`` and reduced to a uint8 mask with
``argmax``, all on the device. The last batch may be shorter than the
others. Single-device, as the JAX engine without a mesh.
"""
from __future__ import annotations

import numpy as np
import torch

from segmentation3d_tpu_torch.ops.geometry import partition_boxes


def make_weight_map(patch_size_zyx, kind: str = "gaussian", sigma_scale: float = 0.125):
    """Per-patch blending weights [pd,ph,pw,1]; 'constant' = plain averaging."""
    pd, ph, pw = patch_size_zyx
    if kind == "constant":
        return np.ones((pd, ph, pw, 1), np.float32)
    zz = np.linspace(-1.0, 1.0, pd)
    yy = np.linspace(-1.0, 1.0, ph)
    xx = np.linspace(-1.0, 1.0, pw)
    sig = 2.0 * sigma_scale
    gz = np.exp(-0.5 * (zz / sig) ** 2)
    gy = np.exp(-0.5 * (yy / sig) ** 2)
    gx = np.exp(-0.5 * (xx / sig) ** 2)
    w = gz[:, None, None] * gy[None, :, None] * gx[None, None, :]
    w = np.maximum(w, w.max() * 1e-3).astype(np.float32)
    return w[..., None]


def tta_axes(tta):
    """Normalize a TTA spec — None/''/'none', 'all', an 'xz'/'x,z' string,
    or an iterable of axis names — to a canonical ('z','y','x')-ordered
    tuple of unique axis names."""
    if tta is None:
        return ()
    if isinstance(tta, str):
        t = tta.strip().lower().replace(",", "")
        if t in ("", "none"):
            return ()
        tta = "zyx" if t == "all" else t
    axes = {str(a).strip().lower() for a in tta}
    bad = axes - {"z", "y", "x"}
    if bad:
        raise ValueError(f"tta axes must be from z/y/x (or 'all'), "
                         f"got {sorted(bad)}")
    return tuple(a for a in ("z", "y", "x") if a in axes)


def tta_flip_combos(axes):
    """All non-empty flip combinations of the named patch axes, as tuples of
    tensor dims of a [B, z, y, x, C] patch batch (z=1, y=2, x=3)."""
    dim = {"z": 1, "y": 2, "x": 3}
    dims = [dim[a] for a in tta_axes(axes)]
    combos = []
    for bits in range(1, 1 << len(dims)):
        combos.append(tuple(d for i, d in enumerate(dims) if bits >> i & 1))
    return tuple(combos)


class SlidingWindowInferer:
    """Whole-volume inference: partition -> batched forward -> blend.

    ``forward(patches [B,pd,ph,pw,Cin]) -> probabilities [B,pd,ph,pw,NC]``.
    ``tta``: test-time mirror augmentation over the named patch axes (see
    :func:`tta_axes`): each batch's probabilities are averaged over every
    flip combination, 2^n forwards per batch.
    """

    def __init__(self, forward, patch_size_zyx, num_classes, batch_size=8,
                 blend="gaussian", tta=None):
        self.forward = forward
        self.patch_size = tuple(int(v) for v in patch_size_zyx)
        self.num_classes = int(num_classes)
        self.batch_size = int(batch_size)
        if blend not in ("gaussian", "constant"):
            raise ValueError(f"unknown blend {blend!r}")
        self.blend = blend
        self.tta = tta_axes(tta)
        self._tta_flips = tta_flip_combos(self.tta)

    def boxes_for(self, vol_shape_zyx, stride_zyx=None):
        """Patch start coordinates (N,3) zyx for a volume shape."""
        pd, ph, pw = self.patch_size
        if stride_zyx is None:
            stride_zyx = self.patch_size
        size_xyz = np.asarray(vol_shape_zyx, np.int64)[::-1]
        boxes_xyz = partition_boxes(size_xyz, (pw, ph, pd), np.asarray(stride_zyx)[::-1])
        return np.ascontiguousarray(boxes_xyz[:, ::-1])  # -> zyx starts

    def _forward(self, patches):
        """The batch's probabilities in float32, averaged over the flips."""
        out = self.forward(patches).to(torch.float32)
        for dims in self._tta_flips:
            out = out + torch.flip(
                self.forward(torch.flip(patches, dims)).to(torch.float32), dims)
        if self._tta_flips:
            out = out / np.float32(1 + len(self._tta_flips))
        return out

    @torch.inference_mode()
    def dice(self, vol, gt, valid_zyx, stride_zyx=None):
        """Per-class Dice of the sliding-window prediction against ``gt``
        (the iso-grid label volume [D,H,W], any dtype with integer values)
        over the unpadded region ``valid_zyx`` (vz, vy, vx), reduced on
        ``vol``'s device: only ``2 * (num_classes - 1)`` numbers are read
        back. Returns a numpy float32 [NC-1] array of
        ``2 * inter / max(|gt==c| + |pred==c|, 1)``."""
        seg = self(vol, stride_zyx=stride_zyx)
        vz, vy, vx = (int(v) for v in valid_zyx)
        seg = seg[:vz, :vy, :vx].to(torch.int32)
        gt = torch.as_tensor(gt).to(seg.device)[:vz, :vy, :vx].to(torch.int32)
        rows = []
        for c in range(1, self.num_classes):
            pc, gc = seg == c, gt == c
            rows.append(torch.stack([(pc & gc).sum(), pc.sum() + gc.sum()]))
        sums = torch.stack(rows).cpu().numpy().astype(np.float32)
        return 2.0 * sums[:, 0] / np.maximum(sums[:, 1], 1.0)

    @torch.inference_mode()
    def __call__(self, vol, stride_zyx=None, return_prob=False):
        """Sliding-window inference over ``vol [D,H,W,Cin]`` (or [D,H,W]) on
        its device. Returns ``mask [D,H,W] uint8`` (+ ``prob [D,H,W,NC]``
        float32 when ``return_prob``)."""
        if vol.dim() == 3:
            vol = vol[..., None]
        pd, ph, pw = self.patch_size
        dev = vol.device
        weight = torch.from_numpy(make_weight_map(self.patch_size, self.blend)).to(dev)
        prob = torch.zeros(tuple(vol.shape[:3]) + (self.num_classes,),
                           dtype=torch.float32, device=dev)
        wsum = torch.zeros(tuple(vol.shape[:3]) + (1,), dtype=torch.float32,
                           device=dev)
        boxes = self.boxes_for(tuple(vol.shape[:3]), stride_zyx)
        for i in range(0, len(boxes), self.batch_size):
            bxs = boxes[i:i + self.batch_size]
            patches = torch.stack([vol[z:z + pd, y:y + ph, x:x + pw]
                                   for z, y, x in bxs.tolist()])
            probs = self._forward(patches)
            for (z, y, x), p in zip(bxs.tolist(), probs):
                prob[z:z + pd, y:y + ph, x:x + pw] += p * weight
                wsum[z:z + pd, y:y + ph, x:x + pw] += weight
        prob = prob / torch.clamp_min(wsum, 1e-8)
        mask = torch.argmax(prob, dim=-1).to(torch.uint8)
        if return_prob:
            return mask, prob
        return mask
