"""Soft Dice losses (V-Net form, squared denominator).

The port of ``segmentation3d_tpu/losses/dice.py``: per class
``(2·Σ(p·g) + eps) / (Σp² + Σg² + eps)`` over each sample's voxels, eps 1,
averaged over the batch, on the net's softmax probabilities (channels last)
against a one-hot target. Loss = 1 - the class-weighted mean Dice, weights
normalized to sum 1 (uniform by default).

When the crop's z planes are spread over the ranks of a ``group`` (the
spatial training shard), each sample's sums are summed over the group
before the ratio, so every rank of the group computes the whole crop's
Dice, as the JAX package's sums do over a sharded crop.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from segmentation3d_tpu_torch.parallel.collectives import group_sum

EPS = 1.0  # smoothing term in both numerator and denominator (V-Net style)


def _over(group, inter, denom):
    if group is None:
        return inter, denom
    both = group_sum(torch.stack([inter, denom]), group)
    return both[0], both[1]


def binary_dice(probs, target, eps: float = EPS, group=None):
    """Soft Dice coefficient of one foreground channel, averaged over the
    leading (batch) axis."""
    probs = probs.reshape(probs.shape[0], -1) if probs.dim() > 1 else probs[None]
    target = target.reshape(target.shape[0], -1) if target.dim() > 1 else target[None]
    target = target.to(probs.dtype)
    inter = torch.sum(probs * target, dim=-1)
    denom = torch.sum(probs * probs, dim=-1) + torch.sum(target * target, dim=-1)
    inter, denom = _over(group, inter, denom)
    return torch.mean((2.0 * inter + eps) / (denom + eps))


def multi_dice_loss(probs, target, weights=None, eps: float = EPS, group=None):
    """``probs [B, ..., C]``, integer ``target [B, ...]`` (or ``[B, ..., 1]``)
    -> ``(loss, per_class_dice [C])``; ``group``: the ranks that hold the
    other z planes of these samples."""
    num_class = probs.shape[-1]
    if target.dim() == probs.dim():
        target = target[..., 0]
    onehot = F.one_hot(target.long(), num_class).to(probs.dtype)
    p = probs.reshape(probs.shape[0], -1, num_class)
    g = onehot.reshape(onehot.shape[0], -1, num_class)
    inter = torch.sum(p * g, dim=1)        # [B, C]
    denom = torch.sum(p * p, dim=1) + torch.sum(g * g, dim=1)
    inter, denom = _over(group, inter, denom)
    dice = torch.mean((2.0 * inter + eps) / (denom + eps), dim=0)  # [C]
    if weights is None:
        w = torch.full((num_class,), 1.0 / num_class, dtype=probs.dtype,
                       device=probs.device)
    else:
        w = torch.as_tensor(weights, dtype=probs.dtype, device=probs.device)
        w = w / torch.sum(w)
    return 1.0 - torch.sum(w * dice), dice


class BinaryDiceLoss:
    """1 - soft Dice on a single foreground channel."""

    def __init__(self, eps: float = EPS, group=None):
        self.eps = eps
        self.group = group

    def __call__(self, probs, target):
        return 1.0 - binary_dice(probs, target, self.eps, self.group)


class MultiDiceLoss:
    """``MultiDiceLoss(weights, num_class)``, the reference's call API."""

    def __init__(self, weights=None, num_class: int | None = None, eps: float = EPS,
                 group=None):
        self.weights = weights
        self.num_class = num_class
        self.eps = eps
        self.group = group

    def __call__(self, probs, target):
        loss, _ = multi_dice_loss(probs, target, self.weights, self.eps, self.group)
        return loss
