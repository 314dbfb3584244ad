"""``seg_eval`` — score predicted masks against ground truth:

    python -m segmentation3d_tpu_torch.cli.seg_eval -p pred_seg.nii.gz -g gt_seg.nii.gz [--surface]
    python -m segmentation3d_tpu_torch.cli.seg_eval -i pairs.csv [-o metrics.csv] [--classes 1 2] [--surface]

``pairs.csv``: header ``pred,gt`` (extra columns ignored), one row per case.
Per-class Dice is always reported; ``--surface`` adds ASSD and HD95 in world
units (mm for standard medical volumes). Masks must share a voxel grid; any
format ``read_image`` reads (NIfTI, MetaImage, NRRD, a DICOM series). The
port's own copy of ``segmentation3d_tpu/cli/seg_eval.py``: the same flags,
output lines and CSV.
"""
from __future__ import annotations

import argparse
import csv
import math
import sys

import numpy as np

from segmentation3d_tpu_torch.io import read_image
from segmentation3d_tpu_torch.utils.metrics import evaluate_masks


def _read_pairs_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if not rows:
        raise ValueError(f"{path} is empty")
    header = [c.strip().lower() for c in rows[0]]
    if "pred" in header and "gt" in header:
        ip, ig = header.index("pred"), header.index("gt")
        rows = rows[1:]
    elif len(rows[0]) >= 2:  # headerless two-column file
        ip, ig = 0, 1
    else:
        raise ValueError(f"{path}: expected columns 'pred,gt'")
    pairs = []
    for r in rows:
        if not r or not any(c.strip() for c in r):
            continue                      # blank line
        if len(r) <= max(ip, ig):
            raise ValueError(
                f"{path}: row {r!r} has {len(r)} columns, needs "
                f"{max(ip, ig) + 1} ('pred' col {ip + 1}, 'gt' col {ig + 1})")
        if r[ip].strip():
            pairs.append((r[ip].strip(), r[ig].strip()))
    return pairs


def _evaluate_pair(pred_path, gt_path, classes, surface):
    pred = read_image(pred_path)
    gt = read_image(gt_path)
    if not np.allclose(pred.frame.spacing, gt.frame.spacing, rtol=1e-3):
        print(f"WARNING: spacing differs between {pred_path} "
              f"({pred.frame.spacing}) and {gt_path} ({gt.frame.spacing}); "
              f"surface distances use the ground-truth spacing",
              file=sys.stderr)
    spacing_zyx = gt.frame.spacing[::-1]
    return evaluate_masks(
        np.rint(pred.data).astype(np.int64), np.rint(gt.data).astype(np.int64),
        spacing_zyx=spacing_zyx, classes=classes, surface=surface)


def _fmt(v):
    return "nan" if (isinstance(v, float) and math.isnan(v)) else f"{v:.4f}"


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Evaluate predicted segmentation masks against ground truth")
    parser.add_argument("-p", "--pred", help="predicted mask file")
    parser.add_argument("-g", "--gt", help="ground-truth mask file")
    parser.add_argument("-i", "--input",
                        help="csv of cases with columns 'pred,gt'")
    parser.add_argument("-o", "--output", default=None,
                        help="write per-case metrics csv here")
    parser.add_argument("--classes", type=int, nargs="+", default=None,
                        help="label values to score (default: all nonzero)")
    parser.add_argument("--surface", action="store_true",
                        help="also compute ASSD and HD95 (world units)")
    args = parser.parse_args(argv)

    if args.input:
        pairs = _read_pairs_csv(args.input)
    elif args.pred and args.gt:
        pairs = [(args.pred, args.gt)]
    else:
        parser.error("give either -i pairs.csv or both -p and -g")

    cols = ["dice"] + (["assd", "hd95"] if args.surface else [])
    out_rows = []
    sums: dict[int, dict[str, list]] = {}
    failed = 0
    for pred_path, gt_path in pairs:
        try:
            per_class = _evaluate_pair(pred_path, gt_path, args.classes,
                                       args.surface)
        except Exception as e:  # per-case isolation, like seg_infer
            failed += 1
            print(f"{pred_path}: FAILED ({e})", file=sys.stderr)
            continue
        for c, row in sorted(per_class.items()):
            vals = " ".join(f"{k}={_fmt(row[k])}" for k in cols)
            print(f"{pred_path} class {c}: {vals}")
            out_rows.append([pred_path, gt_path, c] + [row[k] for k in cols])
            bucket = sums.setdefault(c, {k: [] for k in cols})
            for k in cols:
                if not (isinstance(row[k], float) and math.isnan(row[k])):
                    bucket[k].append(row[k])

    if len(pairs) > 1 and sums:
        for c, bucket in sorted(sums.items()):
            vals = " ".join(
                f"mean_{k}={_fmt(float(np.mean(v)))}" if v else f"mean_{k}=nan"
                for k, v in bucket.items())
            print(f"ALL ({len(pairs) - failed} cases) class {c}: {vals}")

    if args.output:
        with open(args.output, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["pred", "gt", "class"] + cols)
            w.writerows(out_rows)

    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
