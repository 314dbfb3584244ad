"""``seg_infer`` for the PyTorch/CUDA port — the JAX package's flags:

    python -m segmentation3d_tpu_torch.cli.seg_infer
        -i <image|list.txt|list.csv|folder> -m <model_dir> [-m <model_dir> ..]
        -o <out_dir> [-n seg.mha] [-g 0] [--save_image] [--save_prob] [--bf16]
        [--partition_type DISABLE|SIZE|NUM|SLAB] [--partition_size X Y Z]
        [--partition_stride X Y Z] [--batch_size 8] [--blend gaussian]
        [--post largest_cc|remove_small_cc] [--checkpoint WHICH]
        [--int8 [--act_clip A] [--int8_calib IMG[,IMG2..]]] [--tta AXES]
        [--num_devices N [--spatial_shard]]
        [--fine_model <model_dir> [--fine_model ..] [--roi_margin 16]
         [--coarse_checkpoint WHICH] [--fine_checkpoint WHICH]]

``-g N`` runs on ``cuda:N``; ``-g -1`` asks for the CPU. ``--int8`` runs the
int8 forward (and implies ``--bf16``). A repeated ``-m`` is an ensemble;
``--fine_model`` runs coarse-to-fine with ``-m`` as the coarse model. The
JAX CLI's rules for these options hold (``SystemExit`` with its messages).
``--num_devices N`` (-1: every GPU from ``-g`` on; on the CPU, N CPU
shards) splits each volume's patch batches over the devices, or with
``--spatial_shard`` and SLAB partitioning each volume's z axis. Under
torchrun (``WORLD_SIZE`` > 1) each process joins a gloo group and runs its
round-robin slice of the cases:

    torchrun --nproc_per_node 1 --nnodes N ... -m segmentation3d_tpu_torch.cli.seg_infer ...
"""
from __future__ import annotations

import argparse

import torch

from segmentation3d_tpu_torch.core.coarse_to_fine import segmentation_coarse_to_fine
from segmentation3d_tpu_torch.core.seg_infer import DISABLE, segmentation
from segmentation3d_tpu_torch.parallel import distributed


def post_processing_from_args(args):
    """``--post``/``--post_threshold`` -> the post_processing dict."""
    if args.post == "largest_cc":
        return {"type": "largest_cc"}
    if args.post == "remove_small_cc":
        return {"type": "remove_small_cc", "threshold": args.post_threshold}
    return None


def check_option_rules(args):
    """The JAX CLI's rules between the coarse-to-fine and single-model
    options: ``SystemExit`` with its messages."""
    if not args.fine_model and (args.coarse_checkpoint or args.fine_checkpoint):
        raise SystemExit(
            "--coarse_checkpoint/--fine_checkpoint apply to the "
            "coarse-to-fine pipeline (--fine_model); for single-model "
            "inference use --checkpoint")
    if args.fine_model:
        if args.checkpoint:
            raise SystemExit(
                "--checkpoint is ambiguous with --fine_model; use "
                "--coarse_checkpoint / --fine_checkpoint")
        if len(args.model) > 1:
            raise SystemExit(
                "coarse ensembles (-m repeated) are not supported with "
                "--fine_model (the coarse pass only finds the ROI); repeat "
                "--fine_model for a fine-fold ensemble")
        if args.spatial_shard:
            raise SystemExit(
                "--spatial_shard applies to SLAB partitioning, not the "
                "coarse-to-fine pipeline")


def build_parser():
    parser = argparse.ArgumentParser(
        description="3D segmentation inference (PyTorch/CUDA port)")
    parser.add_argument("-i", "--input", required=True,
                        help="input image / .txt list / .csv / folder")
    parser.add_argument("-m", "--model", required=True, action="append",
                        help="model directory; repeat for an ensemble whose "
                             "class probabilities are averaged (members must "
                             "be folds of one configuration)")
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
    parser.add_argument("--int8", action="store_true",
                        help="int8 quantized forward (implies --bf16; "
                             "approximate: validate per model)")
    parser.add_argument("--act_clip", type=float, default=8.0,
                        help="--int8 activation saturation point in "
                             "BN-standardized sigmas (uncalibrated)")
    parser.add_argument("--int8_calib", default=None, metavar="IMAGE[,IMG2..]",
                        help="calibrate --int8 activation scales on this "
                             "representative image (comma-separated paths "
                             "for multi-modality models)")
    parser.add_argument("--tta", default=None, metavar="AXES",
                        help="test-time mirror augmentation: axes of the "
                             "resampled volume to flip ('x', 'zy', 'all'); "
                             "probabilities are averaged over every flip "
                             "combination (2^n forwards per patch)")
    parser.add_argument("--fine_model", default=None, action="append",
                        help="enable coarse-to-fine: -m is the coarse model, "
                             "this is the fine model directory; repeat for a "
                             "fine-fold ensemble (probability averaging)")
    parser.add_argument("--roi_margin", type=float, default=16.0,
                        help="coarse-to-fine ROI margin in mm")
    parser.add_argument("--coarse_checkpoint", default=None, metavar="WHICH",
                        help="coarse-to-fine: which checkpoint of the coarse "
                             "model ('latest'/'best'/epoch)")
    parser.add_argument("--fine_checkpoint", default=None, metavar="WHICH",
                        help="coarse-to-fine: which checkpoint of the fine "
                             "model(s) ('latest'/'best'/epoch)")
    parser.add_argument("--num_devices", type=int, default=1,
                        help=">1 or -1 (all): shard each volume's patch "
                             "batches over the GPUs from -g on")
    parser.add_argument("--spatial_shard", action="store_true",
                        help="with SLAB + --num_devices>1: z-shard each "
                             "volume over the GPUs (halo exchange) instead "
                             "of replicating it — for volumes too large for "
                             "one GPU")
    return parser


def main(argv=None):
    """Parse ``argv`` and run :func:`segmentation` (or, with
    ``--fine_model``, :func:`segmentation_coarse_to_fine`); returns this
    process's results. Under torchrun the process joins the gloo group of
    its peers first, and leaves it at the end."""
    parser = build_parser()
    args = parser.parse_args(argv)
    check_option_rules(args)
    joined = distributed.initialize()
    try:
        return _run(args)
    finally:
        if joined:
            distributed.shutdown()


def _run(args):
    common = dict(
        input_path=args.input, output_dir=args.output, seg_name=args.seg_name,
        gpu_id=args.gpu_id, save_image=args.save_image,
        save_prob=args.save_prob, partition_stride=args.partition_stride,
        batch_size=args.batch_size, blend=args.blend,
        post_processing=post_processing_from_args(args),
        dtype=torch.bfloat16 if (args.bf16 or args.int8) else torch.float32,
        quant="int8" if args.int8 else None, act_clip=args.act_clip,
        calib_image=args.int8_calib.split(",") if args.int8_calib else None,
        tta=args.tta, num_devices=args.num_devices)
    if args.fine_model:
        return segmentation_coarse_to_fine(
            coarse_model_dir=args.model[0],
            fine_model_dir=args.fine_model[0] if len(args.fine_model) == 1
            else args.fine_model,
            partition_size=args.partition_size or (96, 96, 96),
            margin_mm=args.roi_margin,
            coarse_checkpoint=args.coarse_checkpoint,
            fine_checkpoint=args.fine_checkpoint, **common)
    return segmentation(
        model_dir=args.model[0] if len(args.model) == 1 else args.model,
        partition_type=args.partition_type,
        partition_size=args.partition_size, checkpoint=args.checkpoint,
        spatial_shard=args.spatial_shard, **common)


if __name__ == "__main__":
    main()
