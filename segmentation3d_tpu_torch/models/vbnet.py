"""VB-Net registry entry: the bottleneck-block V-Net.

The port of ``segmentation3d_tpu/models/vbnet.py``: checkpoints recording
``net: 'vbnet'`` resolve through :func:`..models.get_network_module` to
:class:`~segmentation3d_tpu_torch.models.vnet.SegmentationNet` with
``bottleneck=True`` (still overridable), whose parameter names are the JAX
package's.
"""
from __future__ import annotations

import functools

from segmentation3d_tpu_torch.models.vnet import SegmentationNet as _VNet
from segmentation3d_tpu_torch.models.vnet import max_stride

__all__ = ["SegmentationNet", "max_stride"]

SegmentationNet = functools.partial(_VNet, bottleneck=True)
