"""Evaluation in the port (``utils/metrics.py``, ``cli/seg_eval.py``) against
the JAX package: the same metrics on phantom masks with anisotropic spacing,
empty masks included, and the same output lines and CSV, byte for byte,
over masks stored as NIfTI, NRRD, MetaImage and a DICOM series."""
import math
import re

import numpy as np
import pytest

from segmentation3d_tpu.cli import seg_eval as jax_eval
from segmentation3d_tpu.utils import metrics as jm
from segmentation3d_tpu_torch.cli import seg_eval
from segmentation3d_tpu_torch.io import Volume, write_image
from segmentation3d_tpu_torch.ops.geometry import Frame
from segmentation3d_tpu_torch.utils import metrics

SPACING_ZYX = (2.5, 0.8, 0.7)


def _labels(shape, seed, classes=2, shift=0.0):
    """Ellipsoids of labels 1..classes at seeded centres."""
    rng = np.random.default_rng(seed)
    z, y, x = np.mgrid[:shape[0], :shape[1], :shape[2]]
    out = np.zeros(shape, np.uint8)
    for c in range(1, classes + 1):
        cz, cy, cx = rng.uniform(0.3, 0.7, 3) * np.asarray(shape) + shift
        r = rng.uniform(0.15, 0.25) * min(shape)
        out[((z - cz) / 0.6) ** 2 + (y - cy) ** 2 + (x - cx) ** 2 < r * r] = c
    return out


def _same(a, b):
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b


PAIRS = {
    "overlap": (_labels((12, 30, 28), 0), _labels((12, 30, 28), 0, shift=1.5)),
    "one_class_missing": (_labels((12, 30, 28), 1, classes=1), _labels((12, 30, 28), 1)),
    "pred_empty": (np.zeros((10, 16, 18), np.uint8), _labels((10, 16, 18), 2)),
    "both_empty": (np.zeros((10, 16, 18), np.uint8), np.zeros((10, 16, 18), np.uint8)),
}


@pytest.mark.parametrize("name", list(PAIRS))
def test_metrics_match_jax(name):
    pred, gt = PAIRS[name]
    for c in (1, 2):
        assert metrics.dice_coefficient(pred == c, gt == c) == \
            jm.dice_coefficient(pred == c, gt == c)
        got = metrics.surface_distances(pred == c, gt == c, SPACING_ZYX)
        ref = jm.surface_distances(pred == c, gt == c, SPACING_ZYX)
        assert all(_same(a, b) for a, b in zip(got, ref))
    for kw in ({}, {"surface": True}, {"classes": [2, 5], "surface": True}):
        got = metrics.evaluate_masks(pred, gt, SPACING_ZYX, **kw)
        ref = jm.evaluate_masks(pred, gt, SPACING_ZYX, **kw)
        assert got.keys() == ref.keys()
        for c in got:
            assert got[c].keys() == ref[c].keys()
            assert all(_same(got[c][k], ref[c][k]) for k in got[c])


def test_shape_mismatch_raises():
    with pytest.raises(ValueError, match="shape mismatch"):
        metrics.evaluate_masks(np.zeros((2, 3, 4)), np.zeros((2, 3, 5)))


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """Three predicted/reference mask pairs stored in different formats, a
    pairs csv, and one pair whose prediction is missing."""
    d = tmp_path_factory.mktemp("eval")
    frame = Frame(np.array([1.0, -2.0, 3.0]), np.array(SPACING_ZYX[::-1]), np.eye(3))
    rows = []
    for i, (pext, gext) in enumerate([(".nii.gz", ".nrrd"), (".mha", ".nhdr"),
                                      (".nrrd", "dicom")]):
        pred, gt = _labels((12, 30, 28), i), _labels((12, 30, 28), i, shift=1.0)
        p, g = str(d / f"pred{i}{pext}"), str(d / f"gt{i}{gext}")
        write_image(Volume(pred, frame), p)
        if gext == "dicom":
            from segmentation3d_tpu_torch.io.dicom import write_dicom_series
            write_dicom_series(g, gt, frame)
        else:
            write_image(Volume(gt, frame), g)
        rows.append(f"{p},{g},extra")
    csv = d / "pairs.csv"
    csv.write_text("pred,gt,note\n" + "\n".join(rows) + "\n\n")
    broken = d / "broken.csv"
    broken.write_text("pred,gt\n" + rows[0].rsplit(",", 1)[0] + "\n"
                      + f"{d / 'missing.nii.gz'},{d / 'gt0.nrrd'}\n")
    return d, str(csv), str(broken), rows


@pytest.mark.parametrize("extra", [[], ["--surface"], ["--classes", "2", "1", "--surface"]])
def test_seg_eval_csv_matches_jax(cases, capsys, extra):
    d, csv, _, _ = cases
    out = {}
    for tag, main in (("jax", jax_eval.main), ("port", seg_eval.main)):
        main(["-i", csv, "-o", str(d / f"{tag}.csv")] + extra)
        out[tag] = capsys.readouterr()
    assert (d / "port.csv").read_bytes() == (d / "jax.csv").read_bytes()
    assert out["port"].out == out["jax"].out
    assert out["port"].out.count("ALL (3 cases)") == 2


def test_seg_eval_single_pair_matches_jax(cases, capsys):
    d, _, _, rows = cases
    p, g, _ = rows[2].split(",")
    jax_eval.main(["-p", p, "-g", g, "--surface"])
    ref = capsys.readouterr().out
    seg_eval.main(["-p", p, "-g", g, "--surface"])
    assert capsys.readouterr().out == ref
    assert "class 2: dice=" in ref


def test_seg_eval_failed_case_exits_1_as_jax(cases, capsys):
    d, _, broken, _ = cases
    for tag, main in (("jax", jax_eval.main), ("port", seg_eval.main)):
        with pytest.raises(SystemExit) as e:
            main(["-i", broken, "-o", str(d / f"{tag}_broken.csv")])
        assert e.value.code == 1
        assert "missing.nii.gz: FAILED" in capsys.readouterr().err
    assert (d / "port_broken.csv").read_bytes() == (d / "jax_broken.csv").read_bytes()


@pytest.mark.parametrize("text", ["a.nii.gz\n", "pred,gt\nx.nii.gz\n"])
def test_bad_pairs_csv_raises_as_jax(tmp_path, text):
    p = tmp_path / "pairs.csv"
    p.write_text(text)
    with pytest.raises(ValueError) as ref:
        jax_eval._read_pairs_csv(str(p))
    with pytest.raises(ValueError, match=re.escape(str(ref.value))):
        seg_eval._read_pairs_csv(str(p))


def test_seg_eval_needs_inputs():
    with pytest.raises(SystemExit) as e:
        seg_eval.main([])
    assert e.value.code == 2
