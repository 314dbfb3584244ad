"""``seg_infer`` for the PyTorch/CUDA port — the JAX package's flags:

    python -m segmentation3d_tpu_torch.cli.seg_infer
        -i <image|list.txt|list.csv|folder> -m <model_dir> -o <out_dir>
        [-n seg.mha] [-g 0] [--save_image] [--save_prob] [--bf16]
        [--partition_type DISABLE|SIZE|NUM|SLAB] [--partition_size X Y Z]
        [--partition_stride X Y Z] [--batch_size 8] [--blend gaussian]
        [--post largest_cc|remove_small_cc] [--checkpoint WHICH]

``-g N`` runs on ``cuda:N``; ``-g -1`` asks for the CPU. Options this port
does not have yet (``--int8``, ``--int8_calib``, ``--act_clip``, ``--tta``,
a repeated ``-m``, ``--fine_model`` and its options, ``--num_devices`` > 1,
``--spatial_shard``) are refused with an error.
"""
from __future__ import annotations

import argparse

import torch

from segmentation3d_tpu_torch.core.seg_infer import DISABLE, segmentation


def post_processing_from_args(args):
    """``--post``/``--post_threshold`` -> the post_processing dict."""
    if args.post == "largest_cc":
        return {"type": "largest_cc"}
    if args.post == "remove_small_cc":
        return {"type": "remove_small_cc", "threshold": args.post_threshold}
    return None


def _not_ported(args):
    """The first given option this port does not have yet, or None."""
    checks = [
        (args.int8, "--int8"),
        (args.int8_calib is not None, "--int8_calib"),
        (args.act_clip is not None, "--act_clip"),
        (args.tta is not None, "--tta"),
        (len(args.model) > 1, "a repeated -m (ensembles)"),
        (args.fine_model is not None, "--fine_model"),
        (args.roi_margin is not None, "--roi_margin"),
        (args.coarse_checkpoint is not None, "--coarse_checkpoint"),
        (args.fine_checkpoint is not None, "--fine_checkpoint"),
        (args.num_devices != 1, "--num_devices other than 1"),
        (args.spatial_shard, "--spatial_shard"),
    ]
    return next((name for given, name in checks if given), None)


def build_parser():
    parser = argparse.ArgumentParser(
        description="3D segmentation inference (PyTorch/CUDA port)")
    parser.add_argument("-i", "--input", required=True,
                        help="input image / .txt list / .csv / folder")
    parser.add_argument("-m", "--model", required=True, action="append",
                        help="model directory")
    parser.add_argument("-o", "--output", required=True, help="output directory")
    parser.add_argument("-n", "--seg_name", default="seg.mha",
                        help="output segmentation file name")
    parser.add_argument("-g", "--gpu_id", type=int, default=0,
                        help="CUDA device index; -1 runs on the CPU")
    parser.add_argument("--save_image", action="store_true",
                        help="also save a copy of the input image")
    parser.add_argument("--save_prob", action="store_true",
                        help="also save per-class probability maps")
    parser.add_argument("--partition_type", default=DISABLE,
                        choices=["DISABLE", "SIZE", "NUM", "SLAB"])
    parser.add_argument("--partition_size", type=int, nargs=3, default=None,
                        metavar=("X", "Y", "Z"))
    parser.add_argument("--partition_stride", type=int, nargs=3, default=None,
                        metavar=("X", "Y", "Z"))
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--blend", default="gaussian", choices=["gaussian", "constant"])
    parser.add_argument("--post", default=None,
                        choices=[None, "largest_cc", "remove_small_cc"],
                        help="connected-component post-processing: keep only "
                             "the largest component, or drop components "
                             "smaller than --post_threshold voxels")
    parser.add_argument("--post_threshold", type=int, default=64,
                        help="minimum component size (voxels) kept by "
                             "--post remove_small_cc")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 compute (the BN-folded kernel forward "
                             "on a CUDA device)")
    parser.add_argument("--checkpoint", default=None, metavar="WHICH",
                        help="which checkpoint of the model dir to run: "
                             "'latest' (default), 'best', or an epoch number")
    # options of the JAX package that are not ported yet: refused
    parser.add_argument("--int8", action="store_true", help="not ported yet")
    parser.add_argument("--act_clip", type=float, default=None, help="not ported yet")
    parser.add_argument("--int8_calib", default=None, help="not ported yet")
    parser.add_argument("--num_devices", type=int, default=1,
                        help="only 1 is ported")
    parser.add_argument("--spatial_shard", action="store_true", help="not ported yet")
    parser.add_argument("--tta", default=None, help="not ported yet")
    parser.add_argument("--fine_model", default=None, action="append",
                        help="not ported yet")
    parser.add_argument("--roi_margin", type=float, default=None, help="not ported yet")
    parser.add_argument("--coarse_checkpoint", default=None, help="not ported yet")
    parser.add_argument("--fine_checkpoint", default=None, help="not ported yet")
    return parser


def main(argv=None):
    """Parse ``argv`` and run :func:`segmentation`; returns its results."""
    parser = build_parser()
    args = parser.parse_args(argv)
    missing = _not_ported(args)
    if missing:
        parser.error(f"{missing} is not ported to the PyTorch/CUDA package yet")
    return segmentation(
        input_path=args.input, model_dir=args.model[0],
        output_dir=args.output, seg_name=args.seg_name, gpu_id=args.gpu_id,
        save_image=args.save_image, save_prob=args.save_prob,
        partition_type=args.partition_type,
        partition_size=args.partition_size,
        partition_stride=args.partition_stride, batch_size=args.batch_size,
        blend=args.blend, post_processing=post_processing_from_args(args),
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        checkpoint=args.checkpoint,
    )


if __name__ == "__main__":
    main()
