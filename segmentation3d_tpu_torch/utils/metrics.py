"""Segmentation evaluation metrics (Dice, surface distances).

Per-class Dice overlap plus the two standard surface metrics (average
symmetric surface distance and 95th-percentile Hausdorff distance), computed
in world units from the volume frames. Host-side numpy/scipy: a mask is
scored once per case. The port's own copy of
``segmentation3d_tpu/utils/metrics.py``.
"""
from __future__ import annotations

import math

import numpy as np
from scipy import ndimage


def dice_coefficient(pred: np.ndarray, gt: np.ndarray) -> float:
    """Binary Dice overlap ``2|P∩G| / (|P|+|G|)``; 1.0 when both are empty."""
    p = pred.astype(bool)
    g = gt.astype(bool)
    denom = int(p.sum()) + int(g.sum())
    if denom == 0:
        return 1.0
    return 2.0 * int(np.logical_and(p, g).sum()) / denom


def _surface(mask: np.ndarray) -> np.ndarray:
    """Boundary voxels of a binary mask (mask minus its 6-conn erosion)."""
    struct = ndimage.generate_binary_structure(3, 1)
    eroded = ndimage.binary_erosion(mask, structure=struct, border_value=0)
    return mask & ~eroded


def surface_distances(pred: np.ndarray, gt: np.ndarray,
                      spacing_zyx) -> tuple[float, float]:
    """(ASSD, HD95) between two binary masks, in world units.

    Distances are measured between boundary-voxel centers with anisotropic
    ``spacing_zyx`` via Euclidean distance transforms (both directions,
    pooled). Returns ``(nan, nan)`` if either mask is empty — surface
    distance is undefined there; Dice already reports the failure.
    """
    p = pred.astype(bool)
    g = gt.astype(bool)
    if not p.any() or not g.any():
        return (math.nan, math.nan)
    sp = np.asarray(spacing_zyx, np.float64)
    ps, gs = _surface(p), _surface(g)
    # distance of every voxel to the nearest gt/pred surface voxel
    d_to_g = ndimage.distance_transform_edt(~gs, sampling=sp)
    d_to_p = ndimage.distance_transform_edt(~ps, sampling=sp)
    all_d = np.concatenate([d_to_g[ps], d_to_p[gs]])
    return (float(all_d.mean()), float(np.percentile(all_d, 95)))


def evaluate_masks(pred: np.ndarray, gt: np.ndarray, spacing_zyx=(1.0, 1.0, 1.0),
                   classes=None, surface: bool = False) -> dict[int, dict]:
    """Per-class metrics between two integer label masks on the same grid.

    ``classes``: label values to score (default: union of nonzero labels in
    either mask). Returns ``{label: {"dice": ..[, "assd": .., "hd95": ..]}}``.
    """
    pred = np.asarray(pred)
    gt = np.asarray(gt)
    if pred.shape != gt.shape:
        raise ValueError(
            f"pred/gt shape mismatch: {pred.shape} vs {gt.shape} — masks must "
            f"be on the same voxel grid (resampling a mask would bias metrics)")
    if classes is None:
        classes = sorted((set(np.unique(pred)) | set(np.unique(gt))) - {0})
        classes = [int(c) for c in classes]
    out = {}
    for c in classes:
        pc, gc = pred == c, gt == c
        row = {"dice": dice_coefficient(pc, gc)}
        if surface:
            assd, hd95 = surface_distances(pc, gc, spacing_zyx)
            row["assd"] = assd
            row["hd95"] = hd95
        out[int(c)] = row
    return out
