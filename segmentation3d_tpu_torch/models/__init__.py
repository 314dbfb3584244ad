"""Model registry: checkpoints name their network (``payload['net']``), and
a model module exposes ``SegmentationNet`` and ``max_stride()``: ``"vnet"`` and ``"vbnet"`` (its
bottleneck variant)."""
from __future__ import annotations

import importlib

_PORTED = ("vnet", "vbnet")


def get_network_module(name: str):
    """Resolve a network name (e.g. ``'vnet'``) to its model module."""
    if name not in _PORTED:
        raise NotImplementedError(f"network {name!r} is not ported yet "
                                  f"(ported: {', '.join(_PORTED)})")
    return importlib.import_module(f"segmentation3d_tpu_torch.models.{name}")
