"""``seg_train`` for the PyTorch/CUDA port — the JAX package's flags:

    python -m segmentation3d_tpu_torch.cli.seg_train -i config.py
        [--folds K [--fold k]] [-g 0]

``-g N`` names the first device: ``cuda:N`` (``-g -1`` asks for the CPU).
Without a CUDA device and without ``-g -1`` it raises. A config whose
mesh asks for several GPUs (``cfg.tpu.mesh.data``, default -1: every
device) trains on every GPU from ``cuda:N`` on, one spawned rank each; on
one GPU or the CPU one process trains. Under torchrun
(``torchrun --nproc_per_node G -m segmentation3d_tpu_torch.cli.seg_train
-i config.py``) each process joins torchrun's group as one rank
(``core/seg_train.py:train_ranks``).
"""
from __future__ import annotations

import argparse


def build_parser():
    parser = argparse.ArgumentParser(
        description="Train a 3D segmentation model (PyTorch/CUDA port)")
    parser.add_argument("-i", "--input", required=True,
                        help="path to the python config file")
    parser.add_argument("--folds", type=int, default=None, metavar="K",
                        help="K-fold cross-validation: split the case list "
                             "deterministically, train each fold on the "
                             "other K-1 with the fold as val_list, into "
                             "<save_dir>_fold<k> (ensemble at inference "
                             "with repeated seg_infer -m)")
    parser.add_argument("--fold", type=int, default=None, metavar="k",
                        help="with --folds: train only fold k")
    parser.add_argument("-g", "--gpu_id", type=int, default=0,
                        help="the first CUDA device index; -1 runs on the CPU")
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.fold is not None and args.folds is None:
        parser.error("--fold requires --folds")
    if args.folds is not None:
        from segmentation3d_tpu_torch.core.folds import train_folds
        return train_folds(args.input, args.folds, fold=args.fold,
                           gpu_id=args.gpu_id)
    from segmentation3d_tpu_torch.core.seg_train import train_ranks
    return train_ranks(args.input, gpu_id=args.gpu_id)


if __name__ == "__main__":
    main()
