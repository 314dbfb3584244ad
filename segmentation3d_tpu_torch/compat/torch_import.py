"""Positional import of checkpoints trained by the original PyTorch toolkit.

The port of ``segmentation3d_tpu/compat/torch_import.py``. The toolkit's
``params.pth`` holds a torch ``state_dict`` whose module names may differ
from the port's. Its V-Net and the port's share one topology (in_block ->
4 down stages -> 4 up stages -> out_block), and a ``state_dict`` keeps the
modules' definition order, so tensors are matched by position, with every
shape checked.

Parameters and BatchNorm running statistics are matched as two separate
ordered streams: torch puts each BatchNorm's ``running_mean`` and
``running_var`` after its weight and bias, the JAX package's flat
template lists every parameter first, and within each stream both keep
the modules' order. ``num_batches_tracked`` is ignored on input and
supplied (0) on output, so ``net.load_state_dict(..., strict=True)``
takes the result. Transposed-conv weights are ``[I, O, 2, 2, 2]`` in
torch's convention on both sides and are taken as they are.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from segmentation3d_tpu_torch.models.vnet import Activation


def _is_stat(key: str) -> bool:
    return key.endswith("running_mean") or key.endswith("running_var")


def template_entries(net: nn.Module):
    """``[(state_dict key, shape)]`` of ``net`` in the JAX package's template
    order: every parameter in module order (conv and transposed-conv
    ``weight``, ``bias``; BatchNorm ``weight`` (flax's scale), ``bias``;
    PReLU ``alpha``), then every BatchNorm's ``running_mean``,
    ``running_var`` in module order."""
    params, stats = [], []
    for name, m in net.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d, nn.BatchNorm3d)):
            params += [(pre + "weight", tuple(m.weight.shape))]
            if m.bias is not None:
                params += [(pre + "bias", tuple(m.bias.shape))]
            if isinstance(m, nn.BatchNorm3d):
                stats += [(pre + k, tuple(getattr(m, k).shape))
                          for k in ("running_mean", "running_var")]
        elif isinstance(m, Activation) and m.kind == "prelu":
            params += [(pre + "alpha", tuple(m.alpha.shape))]
        elif next(m.parameters(recurse=False), None) is not None:
            raise ValueError(f"no template for the parameters of {name} "
                             f"({type(m).__name__})")
    return params + stats


def import_torch_state_dict(torch_sd: dict, net: nn.Module) -> dict:
    """Map an arbitrarily named torch ``state_dict`` onto ``net`` by
    position. Returns a ``state_dict`` (parameters, then the statistics,
    each BatchNorm's ``num_batches_tracked`` after its ``running_var``) that
    ``net.load_state_dict(..., strict=True)`` takes; raises ValueError on a
    structural mismatch."""
    entries = template_entries(net)
    src = [(k, torch.as_tensor(v).detach().cpu()) for k, v in torch_sd.items()
           if not k.endswith("num_batches_tracked")]
    ours_params = [e for e in entries if not _is_stat(e[0])]
    ours_stats = [e for e in entries if _is_stat(e[0])]
    src_params = [e for e in src if not _is_stat(e[0])]
    src_stats = [e for e in src if _is_stat(e[0])]
    if len(src_params) != len(ours_params) or len(src_stats) != len(ours_stats):
        raise ValueError(
            f"structural mismatch: checkpoint has {len(src_params)} params + "
            f"{len(src_stats)} running stats, net expects {len(ours_params)} + "
            f"{len(ours_stats)}")
    mapped = {}
    for (our_key, our_shape), (their_key, t) in zip(
            ours_params + ours_stats, src_params + src_stats):
        if tuple(t.shape) != tuple(our_shape):
            raise ValueError(
                f"shape mismatch at {our_key} <- {their_key}: "
                f"got {tuple(t.shape)}, expected {our_shape}")
        mapped[our_key] = t
        if our_key.endswith("running_var"):
            mapped[our_key[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(0, dtype=torch.int64)
    return mapped
