"""Set-up and the mask check that the inference and serving cells share."""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from portbench import cases, weights
from portbench.reference import nets, pipeline


def engine_options(traffic):
    """``segmentation()``'s engine keywords from a traffic file."""
    xyz = lambda v: list(v[::-1])  # noqa: E731 (the files give z y x)
    return dict(partition_type=traffic["partition_type"],
                partition_size=xyz(traffic["patch"]),
                partition_stride=xyz(traffic["stride"]),
                batch_size=traffic["batch_size"], blend=traffic["blend"],
                shape_bucket=traffic["shape_bucket"],
                dtype=getattr(torch, traffic["dtype"]))


def model_dir(ctx, net):
    """A model directory holding ``net``'s state dict, written by the
    program's checkpoint writer as ``seg_train`` would leave it."""
    from segmentation3d_tpu_torch.utils.model_io import save_checkpoint
    from segmentation3d_tpu_torch.utils.normalizer import FixedNormalizer
    cfg, n = ctx.cfg, ctx.cfg["net"]
    norm = cfg["normalizer"]
    path = os.path.join(ctx.tmp, "model")
    save_checkpoint(path, 1, 0, net.state_dict(), n["name"], 2 ** len(n["down_convs"]),
                    n["in_channels"], n["num_classes"], cfg["spacing_mm"], "LINEAR",
                    [FixedNormalizer(norm["mean"], norm["stddev"], norm["clip"])],
                    extra={"net_kwargs": {k: n[k] for k in
                                          ("base_channels", "down_convs", "up_convs", "act")}})
    return path


class Inputs:
    """The cell's pool of cases (on the device and as files) and its
    seeded reference net (eval mode), with the program's model directory."""

    def __init__(self, ctx):
        dev = torch.device(ctx.device)
        self.pool = cases.make_pool(ctx.seed, ctx.traffic["pool"], dev)
        self.paths = cases.write_pool(self.pool, os.path.join(ctx.tmp, "pool"))
        self.net = weights.seeded(nets.build(ctx.cfg), ctx.seed, ctx.cfg, dev)
        self.model = model_dir(ctx, self.net)
        self.rng = np.random.default_rng(ctx.seed)
        self.reference = {}  # pool index -> the reference's probabilities

    def cycle(self, n):
        """``n`` pool indices: whole cycles over the pool, each in an order
        drawn from the seed, so every run does the same set of cases."""
        k = len(self.pool)
        order = [int(i) for _ in range(-(-n // k)) for i in self.rng.permutation(k)]
        return order[:n]


def write_list(path, images):
    with open(path, "w") as f:
        f.write("\n".join([str(len(images))] + list(images)) + "\n")


def pool_index(name):
    """The pool case of an output name ``[<folder>/]case<i>_<slices>[_<k>]``."""
    return int(os.path.basename(name).split("_", 1)[0][4:])


def check_masks(ctx, inputs, written, sample):
    """Hold a sample of the written masks against the plain float32
    reference. ``written``: ``[(pool index, mask path)]`` of every answer;
    the sample, drawn from the seed, holds ``sample`` of them and always one
    of the pool's largest case. Returns each number of
    :func:`pipeline.mask_gaps` at its largest over the sample, with the
    count of masks that could not be read, and the reference's seconds."""
    t = time.perf_counter()
    rng = np.random.default_rng(ctx.seed + 1)
    largest = max(range(len(inputs.pool)), key=lambda i: inputs.pool[i]["slices"])
    big = [j for j, (i, _) in enumerate(written) if i == largest]
    picked = set(rng.choice(len(written), min(sample, len(written)), replace=False).tolist())
    if big and not picked & set(big):
        picked.pop()
        picked.add(big[0])
    new_sp = tuple(ctx.cfg["spacing_mm"][::-1])
    nums, n_bad = {}, 0
    probs = inputs.reference
    for j in sorted(picked, key=lambda j: written[j][0]):
        i, path = written[j]
        case = inputs.pool[i]
        if i not in probs:
            probs[i] = pipeline.probabilities(inputs.net, case["hu"], case["spacing_zyx"],
                                              ctx.cfg, ctx.traffic)
        try:
            mask, spacing = cases.read_nifti(path)
        except (OSError, ValueError, KeyError) as e:
            print(f"portbench: mask {path} unreadable: {e}")
            n_bad += 1
            continue
        if mask.shape != tuple(case["hu"].shape) or not np.allclose(
                spacing, case["spacing_zyx"], rtol=1e-5):
            print(f"portbench: mask {path} is {mask.shape} at {spacing}, "
                  f"the case {tuple(case['hu'].shape)} at {case['spacing_zyx']}")
            n_bad += 1
            continue
        got = pipeline.mask_gaps(probs[i], torch.from_numpy(mask.copy()),
                                 case["spacing_zyx"], new_sp)
        nums = {k: max(v, nums.get(k, 0.0)) for k, v in got.items()}
    return dict(nums, masks_unreadable=n_bad), time.perf_counter() - t
