"""Sliding-window inference: batched patches, blending on the device.

The port of ``segmentation3d_tpu/core/infer_engine.py``
(``make_weight_map``, ``SlidingWindowInferer``): patches are gathered from
the device-resident normalized volume and forwarded in batches; per-class
probabilities are pasted into float32 ``prob``/``wsum`` accumulators with a
per-patch weight map (Gaussian or constant), divided by ``max(wsum, 1e-8)``
and reduced to a uint8 mask with ``argmax``, all on the device. The last
batch may be shorter than the others.
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


class SlidingWindowInferer:
    """Whole-volume inference: partition -> batched forward -> blend.

    ``forward(patches [B,pd,ph,pw,Cin]) -> probabilities [B,pd,ph,pw,NC]``.
    """

    def __init__(self, forward, patch_size_zyx, num_classes, batch_size=8,
                 blend="gaussian"):
        self.forward = forward
        self.patch_size = tuple(int(v) for v in patch_size_zyx)
        self.num_classes = int(num_classes)
        self.batch_size = int(batch_size)
        if blend not in ("gaussian", "constant"):
            raise ValueError(f"unknown blend {blend!r}")
        self.blend = blend

    def boxes_for(self, vol_shape_zyx, stride_zyx=None):
        """Patch start coordinates (N,3) zyx for a volume shape."""
        pd, ph, pw = self.patch_size
        if stride_zyx is None:
            stride_zyx = self.patch_size
        size_xyz = np.asarray(vol_shape_zyx, np.int64)[::-1]
        boxes_xyz = partition_boxes(size_xyz, (pw, ph, pd), np.asarray(stride_zyx)[::-1])
        return np.ascontiguousarray(boxes_xyz[:, ::-1])  # -> zyx starts

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
            probs = self.forward(patches).to(torch.float32)
            for (z, y, x), p in zip(bxs.tolist(), probs):
                prob[z:z + pd, y:y + ph, x:x + pw] += p * weight
                wsum[z:z + pd, y:y + ph, x:x + pw] += weight
        prob = prob / torch.clamp_min(wsum, 1e-8)
        mask = torch.argmax(prob, dim=-1).to(torch.uint8)
        if return_prob:
            return mask, prob
        return mask
