"""Connected-component post-processing on label masks.

Re-implements ``pick_largest_connected_component`` (≈L290-320) and
``remove_small_connected_component`` (≈L325-355) of the reference's
``utils/image_tools.py``. Runs on host via ``scipy.ndimage.label``
(6-connectivity, matching ITK's default face connectivity); volumes at this
stage are small label masks, so host labeling is not a bottleneck. The
port's own copy of ``segmentation3d_tpu/ops/components.py``.
"""
from __future__ import annotations

import numpy as np
from scipy import ndimage

_STRUCT6 = ndimage.generate_binary_structure(3, 1)  # face connectivity


def pick_largest_connected_component(mask: np.ndarray, labels=None) -> np.ndarray:
    """Keep only the largest connected component of each given label value.

    ``labels``: iterable of label values to process (default: all nonzero).
    """
    mask = np.asarray(mask)
    out = np.array(mask, copy=True)
    if labels is None:
        labels = [v for v in np.unique(mask) if v != 0]
    for lv in labels:
        binary = mask == lv
        if not binary.any():
            continue
        cc, n = ndimage.label(binary, structure=_STRUCT6)
        if n <= 1:
            continue
        sizes = ndimage.sum_labels(binary, cc, index=np.arange(1, n + 1))
        keep = int(np.argmax(sizes)) + 1
        out[binary & (cc != keep)] = 0
    return out


def remove_small_connected_component(mask: np.ndarray, threshold: int, labels=None) -> np.ndarray:
    """Zero out connected components with fewer than ``threshold`` voxels."""
    mask = np.asarray(mask)
    out = np.array(mask, copy=True)
    if labels is None:
        labels = [v for v in np.unique(mask) if v != 0]
    for lv in labels:
        binary = mask == lv
        if not binary.any():
            continue
        cc, n = ndimage.label(binary, structure=_STRUCT6)
        sizes = ndimage.sum_labels(binary, cc, index=np.arange(1, n + 1))
        for comp in np.nonzero(sizes < threshold)[0]:
            out[cc == comp + 1] = 0
    return out
