"""In-training validation: whole-volume inference on a held-out case list at
every save point, scored by per-class Dice on the device.

The port of ``segmentation3d_tpu/core/validation.py:validate_cases``. Each
case is resampled to the training spacing (every modality onto modality 0's
grid) and normalized as ``seg_infer`` prepares it (``prep_channels``), its
labels NN-resampled onto the same grid, and both are padded up to
``shape_bucket``. A padded volume of at most ``size_cap``^3 voxels runs as
one patch; a larger one as ``slab_z``-plane full-XY slabs with
``slab_overlap`` planes of overlap (Gaussian blend). Only the unpadded
region is scored (:meth:`SlidingWindowInferer.dice`), so 2 x (classes - 1)
numbers per case cross to the host. The prepared volumes stay on the device
across save points up to ``case_cache_gb``.

The forward comes from :func:`..core.seg_infer.build_forward` at every
save point, so validation folds where inference folds: a foldable net, with
standard or bottleneck blocks, runs the BN-folded kernel forward
(:func:`..models.fused_vnet.build_fused_forward`), folded again from the
live weights; a net that says it has no folded form (``net.foldable``:
leaky_relu) runs the ``nn.Module`` in eval mode, as the JAX package falls
back, and no fold is tried. A fold that fails on a foldable net
propagates, at any save point, rather than scoring other weights. Float32
runs the module with TF32 off. The net is in train mode again afterwards.
"""
from __future__ import annotations

import types

import numpy as np
import torch

from segmentation3d_tpu_torch.core.infer_engine import SlidingWindowInferer
from segmentation3d_tpu_torch.io import read_image
from segmentation3d_tpu_torch.ops.geometry import resampled_frame
from segmentation3d_tpu_torch.ops.resample import NN, resample_exec, resample_plan


def _prepare_case(img_paths, seg_path, spacing, interpolation, norms,
                  pad_mult, size_cap, slab_z, slab_overlap, device):
    """(vol [D,H,W,C], gt [D,H,W], valid_xyz, patch, stride) on ``device``."""
    from segmentation3d_tpu_torch.core.seg_infer import prep_channels
    vols = [read_image(p) for p in img_paths]
    v0 = vols[0]
    _, valid = resampled_frame(v0.frame, v0.size_xyz, spacing, 1)
    iso_frame, iso_size = resampled_frame(v0.frame, v0.size_xyz, spacing,
                                          pad_mult)
    shim = types.SimpleNamespace(
        normalizers=norms if norms is not None else [None] * len(vols),
        interpolation=interpolation)
    vol = prep_channels(shim, vols, None, iso_frame, iso_size, valid, 0.0,
                        device)
    sv = read_image(seg_path)
    kind, coeffs, out_shape = resample_plan(sv.frame, iso_frame, iso_size)
    seg = torch.from_numpy(np.asarray(sv.data, np.float32)).to(device)
    gt = resample_exec(seg, kind, coeffs, out_shape, NN, 0.0,
                       out_dtype=torch.float32)
    D, H, W = (int(s) for s in iso_size[::-1])
    if D * H * W > int(size_cap) ** 3:
        pz = min(int(slab_z), D)
        sz = max(pz - int(slab_overlap), 1)
        patch, stride = (pz, H, W), (sz, H, W)
    else:
        patch = stride = (D, H, W)
    return vol, gt, valid, patch, stride


def validate_cases(net, val_list, *, spacing, interpolation, normalizers,
                   num_classes, max_stride, shape_bucket=32, dtype=torch.float32,
                   inferer_cache=None, size_cap=256, slab_z=64,
                   slab_overlap=16, case_cache_gb=2.0):
    """Run whole-volume inference with ``net`` (on its device) on every case
    of ``val_list`` (train-format txt or csv) and return ``(mean_dice,
    per_class_dice, n_cases)``: ``per_class_dice[c-1]`` is the mean Dice of
    class ``c`` over the cases, ``mean_dice`` their mean.

    ``inferer_cache``: a dict kept for the whole run (the device case cache
    lives there). ``dtype``: bfloat16 or float32."""
    from segmentation3d_tpu_torch.core import seg_infer
    from segmentation3d_tpu_torch.dataloader.dataset import read_case_list
    if inferer_cache is None:
        inferer_cache = {}
    device = next(net.parameters()).device
    pad_mult = max(int(max_stride), int(shape_bucket or 0))
    norms = list(normalizers) if normalizers is not None else None
    ims, sgs = read_case_list(val_list)
    case_cache = inferer_cache.setdefault(
        "__cases__", {"budget": float(case_cache_gb) * 1e9})
    was_training = net.training
    net.eval()
    try:
        forward = seg_infer.build_forward(net, dtype, device)
        per_case = []
        for img_paths, seg_path in zip(ims, sgs):
            ckey = (tuple(img_paths), seg_path)
            cached = case_cache.get(ckey)
            if cached is None:
                cached = _prepare_case(img_paths, seg_path, spacing,
                                       interpolation, norms, pad_mult,
                                       size_cap, slab_z, slab_overlap, device)
                vol, gt = cached[:2]
                nbytes = vol.numel() * vol.element_size() \
                    + gt.numel() * gt.element_size()
                if case_cache["budget"] >= nbytes:
                    case_cache["budget"] -= nbytes
                    case_cache[ckey] = cached
            vol, gt, valid, patch, stride = cached
            inferer = SlidingWindowInferer(
                forward, patch, num_classes, batch_size=1,
                blend="constant" if patch == stride else "gaussian")
            valid_zyx = (int(valid[2]), int(valid[1]), int(valid[0]))
            dices = inferer.dice(vol, gt, valid_zyx, stride_zyx=stride)
            per_case.append([float(d) for d in dices])
    finally:
        net.train(was_training)
    if not per_case:
        return 0.0, [], 0
    per_class = np.mean(np.asarray(per_case, np.float64), axis=0)
    return float(per_class.mean()), [float(d) for d in per_class], len(per_case)
