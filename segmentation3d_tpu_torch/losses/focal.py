"""Focal loss on softmax probabilities.

The port of ``segmentation3d_tpu/losses/focal.py``: on the net's output
probabilities (channels last), with per-class ``alpha`` and focusing
``gamma``:

    loss = mean over voxels of  -alpha_c * (1 - p_c)^gamma * log(p_c)

where ``c`` is each voxel's true class and ``p_c`` is clipped to
``[eps, 1]``, eps 1e-7. Over several ranks it is each rank's mean over its
own voxels: every rank holds as many, so DDP's average of the ranks'
gradients is the whole batch's.
"""
from __future__ import annotations

import torch


def focal_loss(probs, target, alpha=None, gamma: float = 2.0, eps: float = 1e-7):
    """``probs [B, ..., C]`` probabilities; ``target [B, ...]`` int labels."""
    num_class = probs.shape[-1]
    if target.dim() == probs.dim():
        target = target[..., 0]
    target = target.long()
    pt = torch.gather(probs, -1, target[..., None])[..., 0]  # true class
    pt = torch.clamp(pt, eps, 1.0)
    if alpha is None:
        a = torch.ones((num_class,), dtype=probs.dtype, device=probs.device)
    else:
        a = torch.as_tensor(alpha, dtype=probs.dtype, device=probs.device)
        if a.dim() == 0:
            a = torch.full((num_class,), float(a), dtype=probs.dtype,
                           device=probs.device)
    at = a[target]
    return torch.mean(-at * torch.pow(1.0 - pt, gamma) * torch.log(pt))


class FocalLoss:
    """``FocalLoss(class_num, alpha, gamma)``, the reference's call API."""

    def __init__(self, class_num: int, alpha=None, gamma: float = 2.0):
        self.class_num = class_num
        self.alpha = alpha
        self.gamma = gamma

    def __call__(self, probs, target):
        return focal_loss(probs, target, self.alpha, self.gamma)
