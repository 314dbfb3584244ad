"""``seg_serve`` for the PyTorch/CUDA port — warm-session serving with the
JAX package's flags (plus ``-g``):

    python -m segmentation3d_tpu_torch.cli.seg_serve -m <model_dir>
        --socket /run/seg.sock [engine options] [-g 0]
    python -m segmentation3d_tpu_torch.cli.seg_serve -m <model_dir>
        --port 7332 [--host 0.0.0.0] [engine options]

    echo '{"input": "/data/case.nii.gz", "output_dir": "/out"}' | nc -U /run/seg.sock

One process keeps the models loaded, their forwards built and any int8
calibration done (the session caches of ``core.seg_infer`` and
``core.coarse_to_fine``) and serves requests over the newline-delimited
JSON protocol of :mod:`..core.serve`. Engine options are ``seg_infer``'s
and are fixed at server start. ``-g N`` serves on ``cuda:N``; ``-g -1``
asks for the CPU; without a CUDA device and without ``-g -1`` it raises.
``--num_devices`` and ``--spatial_shard`` shard each request's volumes as
in ``seg_infer``; the devices are chosen once, at server start.
"""
from __future__ import annotations

import argparse
import tempfile
import time

import torch

from segmentation3d_tpu_torch.cli.seg_infer import post_processing_from_args
from segmentation3d_tpu_torch.core.coarse_to_fine import segmentation_coarse_to_fine
from segmentation3d_tpu_torch.core.seg_infer import DISABLE, prepare_cases, segmentation
from segmentation3d_tpu_torch.core.serve import SegmentationServer, serve_forever
from segmentation3d_tpu_torch.parallel import shard_devices


def build_parser():
    parser = argparse.ArgumentParser(
        description="3D segmentation serving daemon, warm sessions "
                    "(PyTorch/CUDA port)")
    parser.add_argument("-m", "--model", required=True, action="append",
                        help="model directory; repeat for an ensemble "
                             "(probability averaging, like seg_infer)")
    parser.add_argument("--socket", default=None, metavar="PATH",
                        help="listen on this Unix-domain socket")
    parser.add_argument("--port", type=int, default=None,
                        help="listen on this TCP port instead of --socket")
    parser.add_argument("--host", default="127.0.0.1",
                        help="TCP bind address (with --port)")
    parser.add_argument("--warmup", default=None, metavar="IMAGE",
                        help="segment this representative image into a temp "
                             "dir before accepting requests, so the first "
                             "real request pays no model load or build")
    parser.add_argument("-n", "--seg_name", default="seg.mha",
                        help="default output segmentation file name "
                             "(overridable per request)")
    parser.add_argument("-g", "--gpu_id", type=int, default=0,
                        help="CUDA device index; -1 serves on the CPU")
    # engine options — same surface as seg_infer, fixed for the server's life
    parser.add_argument("--partition_type", default=DISABLE,
                        choices=["DISABLE", "SIZE", "NUM", "SLAB"])
    parser.add_argument("--partition_size", type=int, nargs=3, default=None,
                        metavar=("X", "Y", "Z"))
    parser.add_argument("--partition_stride", type=int, nargs=3, default=None,
                        metavar=("X", "Y", "Z"))
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--blend", default="gaussian",
                        choices=["gaussian", "constant"])
    parser.add_argument("--post", default=None,
                        choices=[None, "largest_cc", "remove_small_cc"])
    parser.add_argument("--post_threshold", type=int, default=64)
    parser.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    parser.add_argument("--int8", action="store_true",
                        help="int8 quantized forward (implies --bf16)")
    parser.add_argument("--act_clip", type=float, default=8.0)
    parser.add_argument("--int8_calib", default=None, metavar="IMAGE[,IMG2..]")
    parser.add_argument("--num_devices", type=int, default=1)
    parser.add_argument("--spatial_shard", action="store_true")
    parser.add_argument("--checkpoint", default=None, metavar="WHICH",
                        help="'latest' (default), 'best', or an epoch number")
    parser.add_argument("--tta", default=None, metavar="AXES")
    parser.add_argument("--fine_model", default=None,
                        help="serve the coarse-to-fine pipeline: -m is the "
                             "coarse model, this is the fine model directory")
    parser.add_argument("--roi_margin", type=float, default=16.0)
    parser.add_argument("--idle_timeout", type=float, default=30.0,
                        help="drop a connection that sends no complete "
                             "request within this many seconds (a wedged "
                             "client must not block the serial queue; 0: "
                             "no limit)")
    parser.add_argument("--max_request_bytes", type=int, default=1 << 20,
                        help="reject request lines longer than this")
    return parser


def main(argv=None):
    """Parse ``argv``, build the request pipeline and serve until a
    ``shutdown`` request."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if (args.socket is None) == (args.port is None):
        parser.error("exactly one of --socket / --port is required")
    if args.fine_model:
        if args.checkpoint:
            parser.error("--checkpoint is ambiguous with --fine_model; use "
                         "--coarse_checkpoint / --fine_checkpoint (seg_infer "
                         "flags) via a direct seg_infer run, or serve with "
                         "the default latest checkpoints")
        if len(args.model) > 1:
            parser.error("coarse ensembles (-m repeated) are not supported "
                         "with --fine_model")
        if args.spatial_shard:
            parser.error("--spatial_shard applies to SLAB partitioning, not "
                         "the coarse-to-fine pipeline")
    devs = shard_devices(args.num_devices, None, args.gpu_id)
    common = dict(
        batch_size=args.batch_size, blend=args.blend,
        post_processing=post_processing_from_args(args),
        dtype=torch.bfloat16 if (args.bf16 or args.int8) else torch.float32,
        quant="int8" if args.int8 else None, act_clip=args.act_clip,
        calib_image=args.int8_calib.split(",") if args.int8_calib else None,
        tta=args.tta, partition_stride=args.partition_stride, device=devs)

    if args.fine_model:
        def run_fn(input_path, output_dir, seg_name, save_image, save_prob,
                   prepared=None):
            return segmentation_coarse_to_fine(
                input_path=input_path, coarse_model_dir=args.model[0],
                fine_model_dir=args.fine_model, output_dir=output_dir,
                seg_name=seg_name,
                partition_size=args.partition_size or (96, 96, 96),
                margin_mm=args.roi_margin, save_image=save_image,
                save_prob=save_prob, prepared=prepared, **common)
    else:
        def run_fn(input_path, output_dir, seg_name, save_image, save_prob,
                   prepared=None):
            return segmentation(
                input_path=input_path,
                model_dir=args.model[0] if len(args.model) == 1 else args.model,
                output_dir=output_dir, seg_name=seg_name,
                save_image=save_image, save_prob=save_prob,
                partition_type=args.partition_type,
                partition_size=args.partition_size,
                spatial_shard=args.spatial_shard,
                checkpoint=args.checkpoint, prepared=prepared, **common)

    if args.warmup:
        t0 = time.time()
        with tempfile.TemporaryDirectory() as tmp:
            run_fn(args.warmup, tmp, args.seg_name, False, False)
        print(f"seg_serve: warmup done in {time.time() - t0:.1f} s")

    def prep_fn(req):
        # the next request's case discovery + read-ahead (decode, upload on
        # its own CUDA stream) while the current request computes
        return prepare_cases(str(req["input"]), device=devs[0])

    server = SegmentationServer(run_fn, ",".join(args.model),
                                seg_name=args.seg_name)
    serve_forever(server, socket_path=args.socket,
                  host=args.host, port=args.port,
                  idle_timeout=args.idle_timeout,
                  max_request_bytes=args.max_request_bytes,
                  prep_fn=prep_fn)


if __name__ == "__main__":
    main()
