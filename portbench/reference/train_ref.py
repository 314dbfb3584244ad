"""Three plain float32 training steps, and how far the program's are from them.

One step: the net in train mode (BatchNorm on the batch's statistics) on a
batch of crops ``[B, D, H, W, 1]``, the softmax, the V-Net soft Dice loss
(per class ``(2 sum(p g) + 1) / (sum(p^2) + sum(g^2) + 1)`` over each
crop, averaged over the batch, one minus its mean over the classes), its
gradient, and one Adam update (``eps`` 1e-8, bias-corrected moments).

:func:`compare` runs three such steps from the benchmark's initial weights
on the crops the program trained on and returns, each as the worst over
the steps or the leaves:

- ``loss_gap``: a step's loss against the reference's, over the
  reference's;
- ``grad_gap``: a leaf's first-step gradient norm (the program's worked
  out from Adam's first moment after one step) against the reference's,
  over the larger of the reference's leaf norm and the median leaf's;
- ``update_gap``: the same for the norm of each leaf's change after three
  steps;
- ``grad_gap_median`` and ``update_gap_median``: the median leaf's gap,
  steady from seed to seed where the worst leaf's swings with the round-off
  of one small leaf.

Leaves whose reference gradient is under a thousandth of the median
leaf's (a conv's bias in front of BatchNorm: moved by round-off alone)
are left out of both leaf numbers.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.nets import build, exact


def dice_loss(logits, target, classes):
    p = torch.softmax(logits, dim=1).flatten(2)               # [B, C, V]
    g = F.one_hot(target.long().flatten(1), classes).transpose(1, 2).to(p.dtype)
    dice = (2 * (p * g).sum(-1) + 1) / ((p * p).sum(-1) + (g * g).sum(-1) + 1)
    return 1 - dice.mean(0).mean()


def steps(net, batches, lr, betas, classes, eps=1e-8):
    """Run the Adam steps on ``batches``; returns ``(losses, first
    gradient by leaf)``. ``net`` is changed in place."""
    params = dict(net.named_parameters())
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, grad1 = [], None
    net.train()
    with exact():
        for t, (images, segs) in enumerate(batches, 1):
            net.zero_grad(set_to_none=True)
            x = images.to(torch.float32).permute(0, 4, 1, 2, 3)
            loss = dice_loss(net(x), segs, classes)
            loss.backward()
            losses.append(float(loss.detach()))
            with torch.no_grad():
                if grad1 is None:
                    grad1 = {k: p.grad.clone() for k, p in params.items()}
                for k, p in params.items():
                    m[k].mul_(betas[0]).add_((1 - betas[0]) * p.grad)
                    v[k].mul_(betas[1]).add_((1 - betas[1]) * p.grad * p.grad)
                    mh = m[k] / (1 - betas[0] ** t)
                    vh = v[k] / (1 - betas[1] ** t)
                    p.sub_(lr * mh / (vh.sqrt() + eps))
    return losses, grad1


def leaf_gaps(got, want, keep):
    """Per leaf of ``keep``: ``|norm(got) - norm(want)|`` over the larger of
    ``norm(want)`` and the median leaf's norm; with the median norm."""
    norms = {k: float(want[k].norm()) for k in keep}
    med = sorted(norms.values())[len(norms) // 2]
    return {k: abs(float(got[k].norm()) - norms[k]) / max(norms[k], med) for k in keep}, \
        norms, med


def _summary(name, got, want, keep):
    """The worst leaf's gap, and for the look: which leaf, its norm over
    the median leaf's, the median leaf's gap and the gap of all leaves'
    norm together."""
    per, norms, med = leaf_gaps(got, want, keep)
    worst = max(per, key=per.get)
    whole = float(torch.sqrt(sum(want[k].double().norm() ** 2 for k in keep)))
    whole_got = float(torch.sqrt(sum(got[k].double().norm() ** 2 for k in keep)))
    return {name: per[worst], f"{name}.leaf": worst,
            f"{name}.leaf_over_median": norms[worst] / med,
            f"{name}_median": sorted(per.values())[len(per) // 2],
            f"{name}.all": abs(whole_got - whole) / whole}


def reference_run(cfg, traffic, start, batches, device, net=None):
    """Three reference steps from ``start``: ``(losses, grad1, change)``."""
    if net is None:
        net = build(cfg)
    net.load_state_dict(start)
    net.to(device)
    w0 = {k: p.detach().clone() for k, p in net.named_parameters()}
    losses, grad1 = steps(net, batches, traffic["lr"], traffic["betas"],
                          cfg["net"]["num_classes"])
    change = {k: p.detach() - w0[k] for k, p in net.named_parameters()}
    return losses, grad1, change


def gaps(ref, got):
    """The three compared numbers of ``got`` against ``ref``, each a
    ``(losses, grad1, change)``."""
    (rl, rg, rc), (gl, gg, gc) = ref, got
    norms = {k: float(g.norm()) for k, g in rg.items()}
    med = sorted(norms.values())[len(norms) // 2]
    keep = [k for k, n in norms.items() if n >= 1e-3 * med]
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(gl, rl)),
            **_summary("grad_gap", gg, rg, keep), **_summary("update_gap", gc, rc, keep),
            "leaves_left_out": len(norms) - len(keep)}


def captured(cap, start, device):
    """``(losses, grad1, change)`` of the program's captured steps."""
    w0 = {k: start[k].to(device) for k in cap.after}
    return ([float(x) for x in cap.losses], cap.grad1,
            {k: cap.after[k] - w0[k] for k in cap.after})


def compare(cfg, traffic, start, cap, device):
    """The program's first three steps (a ``Capture``) against the
    reference's on the same crops."""
    batches = [(x.to(device), y.to(device)) for x, y in cap.batches]
    return gaps(reference_run(cfg, traffic, start, batches, device),
                captured(cap, start, device))
