"""Intensity normalizers on torch tensors.

The port of ``segmentation3d_tpu/utils/normalizer.py``:
``FixedNormalizer(mean, stddev, clip)`` and ``AdaptiveNormalizer(min_p,
max_p, clip)`` with the same ``to_dict``/``from_dict`` payloads that
checkpoints embed (key ``crop_normalizers``).
"""
from __future__ import annotations

import numpy as np
import torch


def percentile(x: torch.Tensor, pct) -> torch.Tensor:
    """``jnp.percentile(x, pct)`` with its default linear interpolation, in
    float32 as JAX computes it; ``pct`` is a number or a sequence of them,
    all taken from one sort (``torch.quantile`` refuses inputs above 2**24
    elements, and a 512^3 CT volume has 134M voxels)."""
    flat = x.reshape(-1).to(torch.float32)
    n = flat.numel()
    s = torch.sort(flat).values
    vals = []
    for p in np.atleast_1d(np.asarray(pct, np.float32)):
        # position arithmetic in float32, step by step as jnp.quantile does it
        q = np.float32(p) / np.float32(100.0)
        pos = np.float32(q * np.float32(np.float32(n) - np.float32(1.0)))
        low, high = np.floor(pos), np.ceil(pos)
        hw = np.float32(pos - low)
        lw = np.float32(np.float32(1.0) - hw)
        lo_i = int(min(max(low, 0), n - 1))
        hi_i = int(min(max(high, 0), n - 1))
        vals.append(s[lo_i] * float(lw) + s[hi_i] * float(hw))
    return vals[0] if np.ndim(pct) == 0 else torch.stack(vals)


class FixedNormalizer:
    """``(x - mean) / stddev``, optionally clipped to [-1, 1]."""

    def __init__(self, mean, stddev, clip=True):
        if not stddev > 0:
            raise ValueError("stddev must be positive")
        self.mean = float(mean)
        self.stddev = float(stddev)
        self.clip = bool(clip)

    def __call__(self, x, stats_of=None):
        del stats_of  # fixed statistics
        x = (x.to(torch.float32) - self.mean) / self.stddev
        if self.clip:
            x = torch.clamp(x, -1.0, 1.0)
        return x

    def to_dict(self):
        return {"type": 0, "mean": self.mean, "stddev": self.stddev, "clip": self.clip}

    @staticmethod
    def from_dict(d):
        return FixedNormalizer(d["mean"], d["stddev"], d["clip"])


class AdaptiveNormalizer:
    """Percentile-window rescale to [-1, 1]: ``[P(min_p), P(max_p)]`` maps
    linearly onto [-1, 1]; values outside are clipped when ``clip`` is set."""

    def __init__(self, min_p=0.001, max_p=0.999, clip=True):
        if not 0 <= min_p < max_p <= 1:
            raise ValueError("percentiles must satisfy 0 <= min_p < max_p <= 1")
        self.min_p = float(min_p)
        self.max_p = float(max_p)
        self.clip = bool(clip)

    def __call__(self, x, stats_of=None):
        """``stats_of``: optional tensor to take the percentile window from
        (e.g. the unpadded region of a padded volume); defaults to ``x``."""
        x = x.to(torch.float32)
        src = x if stats_of is None else stats_of
        lo, hi = percentile(src, (self.min_p * 100.0, self.max_p * 100.0))
        scale = torch.clamp_min(hi - lo, 1e-8)
        x = (x - lo) / scale * 2.0 - 1.0
        if self.clip:
            x = torch.clamp(x, -1.0, 1.0)
        return x

    def to_dict(self):
        return {"type": 1, "min_p": self.min_p, "max_p": self.max_p, "clip": self.clip}

    @staticmethod
    def from_dict(d):
        return AdaptiveNormalizer(d["min_p"], d["max_p"], d["clip"])


def normalizer_from_dict(d):
    """Reconstruct a normalizer from its checkpoint payload (type tag 0/1)."""
    t = d.get("type")
    if t == 0:
        return FixedNormalizer.from_dict(d)
    if t == 1:
        return AdaptiveNormalizer.from_dict(d)
    raise ValueError(f"unknown normalizer type: {d}")
