"""Model registry: checkpoints name their network (``payload['net']``), and
a model module exposes ``SegmentationNet`` and ``max_stride()``, and ``TRAINABLE = False``
where ``seg_train`` cannot train it: ``"vnet"``, ``"vbnet"`` (its bottleneck variant) and
``"swin_unetr"`` (inference only)."""
from __future__ import annotations

import importlib

_PORTED = ("vnet", "vbnet", "swin_unetr")


def get_network_module(name: str):
    """Resolve a network name (e.g. ``'vnet'``) to its model module."""
    if name not in _PORTED:
        raise NotImplementedError(f"network {name!r} is not ported yet "
                                  f"(ported: {', '.join(_PORTED)})")
    return importlib.import_module(f"segmentation3d_tpu_torch.models.{name}")


def create_network(name: str, in_channels: int, out_channels: int, **kwargs):
    """A new ``SegmentationNet`` of the network ``name``."""
    mod = get_network_module(name)
    return mod.SegmentationNet(in_channels=in_channels, out_channels=out_channels, **kwargs)


def trainable(name: str) -> bool:
    """Whether ``seg_train`` trains the network ``name`` (its module's ``TRAINABLE``)."""
    return getattr(get_network_module(name), "TRAINABLE", True)


def max_stride_of(name: str) -> int:
    """Total down-sampling factor of the network ``name``."""
    return get_network_module(name).max_stride()
