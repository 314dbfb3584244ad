from segmentation3d_tpu_torch.losses.dice import BinaryDiceLoss, MultiDiceLoss, multi_dice_loss
from segmentation3d_tpu_torch.losses.focal import FocalLoss, focal_loss


def create_loss(cfg_loss, num_classes: int, z_group=None):
    """Select the loss by ``cfg.loss.name``: 'Focal' -> FocalLoss (alpha
    ``obj_weight``, else ``[1 - a] + [a] * (C - 1)`` with ``a =
    focal_obj_alpha``), 'Dice' -> MultiDiceLoss (weights ``obj_weight``).
    ``z_group``: the ranks that hold the other z planes of each crop (the
    spatial training shard); Dice sums over them."""
    name = cfg_loss.name
    if name == "Focal":
        alpha = getattr(cfg_loss, "obj_weight", None)
        if alpha is None:
            oa = float(getattr(cfg_loss, "focal_obj_alpha", 0.25))
            alpha = [1.0 - oa] + [oa] * (num_classes - 1)
        return FocalLoss(class_num=num_classes, alpha=alpha,
                         gamma=float(getattr(cfg_loss, "focal_gamma", 2.0)))
    if name == "Dice":
        weights = getattr(cfg_loss, "obj_weight", None)
        return MultiDiceLoss(weights=weights, num_class=num_classes, group=z_group)
    raise ValueError(f"unknown loss name {name!r} (expected 'Focal' or 'Dice')")
