"""The port's session caches, on the CPU: ``core.seg_infer._SESSIONS``
(models, forwards with their int8 calibration, inferers) and
``core.coarse_to_fine._C2F_SESSIONS``, as the JAX package keeps its
sessions: a repeat call loads and builds nothing, a rewritten checkpoint or
another option rebuilds, the cap drops the oldest, and a failed build
leaves nothing behind. Loads, builds and calibrations are counted through
monkeypatch."""
import os

import numpy as np
import pytest
import torch

from segmentation3d_tpu_torch.core import coarse_to_fine as c2f
from segmentation3d_tpu_torch.core import seg_infer as si
from segmentation3d_tpu_torch.io import Volume, read_image, write_image
from segmentation3d_tpu_torch.ops.geometry import Frame
from segmentation3d_tpu_torch.utils import model_io
from segmentation3d_tpu_torch.utils.normalizer import FixedNormalizer
from test_torch_port_checkpoint import KW, seeded_variables


@pytest.fixture(scope="module")
def model_and_case(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sessions"))
    _, net = seeded_variables(seed=5)
    model_dir = os.path.join(d, "model")
    model_io.save_checkpoint(model_dir, 1, 0, net.state_dict(), "vnet", 4, 1, 2,
                             [1.0, 1.0, 1.0], "LINEAR", [FixedNormalizer(0.0, 1.0)],
                             extra={"net_kwargs": dict(KW)})
    img = np.random.default_rng(0).normal(0.0, 1.0, (20, 24, 20)).astype(np.float32)
    case = os.path.join(d, "case.nii.gz")
    write_image(Volume(img, Frame.identity()), case)
    return d, model_dir, case


@pytest.fixture
def counts(monkeypatch):
    """Empty session caches for the test, and counting wrappers around what
    a session build runs."""
    monkeypatch.setattr(si, "_SESSIONS", {})
    monkeypatch.setattr(c2f, "_C2F_SESSIONS", {})
    n = {"load": 0, "build": 0, "calib": 0}

    def counting(mod, name, key):
        fn = getattr(mod, name)

        def wrapper(*a, **kw):
            n[key] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapper)
    for mod in (si, c2f):
        counting(mod, "load_seg_model", "load")
        counting(mod, "build_forward", "build")
    counting(si, "_calibrate_for_model", "calib")
    return n


def _run(model_and_case, tag, **kw):
    d, model_dir, case = model_and_case
    out = os.path.join(d, tag)
    res = si.segmentation(case, model_dir, out, device="cpu", shape_bucket=16, **kw)
    return read_image(os.path.join(out, res[0][0], "seg.mha")).data


def test_repeat_call_loads_and_builds_nothing(model_and_case, counts):
    first = _run(model_and_case, "r1", batch_size=2)
    assert (counts["load"], counts["build"]) == (1, 1)
    sess = next(iter(si._SESSIONS.values()))
    assert len(sess["inferers"]) == 1
    second = _run(model_and_case, "r2", batch_size=2)
    assert (counts["load"], counts["build"]) == (1, 1)
    assert len(si._SESSIONS) == 1
    np.testing.assert_array_equal(first, second)


@pytest.mark.parametrize("change", ["mtime", "batch_size", "tta", "dtype", "checkpoint"])
def test_changed_checkpoint_or_option_rebuilds(model_and_case, counts, change):
    d, model_dir, _ = model_and_case
    _run(model_and_case, f"a_{change}", batch_size=2)
    kw = dict(batch_size=2)
    if change == "mtime":
        p = os.path.join(model_io.latest_checkpoint(model_dir), "params.pth")
        t = os.path.getmtime(p) + 5.0
        os.utime(p, (t, t))
    elif change == "batch_size":
        kw["batch_size"] = 3
    elif change == "tta":
        kw["tta"] = "x"
    elif change == "dtype":
        kw["dtype"] = torch.bfloat16
    else:
        kw["checkpoint"] = "best"
        chk = os.path.join(model_dir, "checkpoints", "chk_best")
        if not os.path.isdir(chk):
            import shutil
            shutil.copytree(model_io.latest_checkpoint(model_dir), chk)
    _run(model_and_case, f"b_{change}", **kw)
    assert (counts["load"], counts["build"]) == (2, 2)
    assert len(si._SESSIONS) == 2


def test_cap_drops_the_oldest(model_and_case, counts):
    for b in range(1, si._SESSION_CAP + 2):
        _run(model_and_case, f"cap{b}", batch_size=b)
    assert counts["load"] == si._SESSION_CAP + 1
    assert len(si._SESSIONS) == si._SESSION_CAP
    assert sorted(k[4] for k in si._SESSIONS) == list(range(2, si._SESSION_CAP + 2))
    _run(model_and_case, "cap_last", batch_size=si._SESSION_CAP + 1)  # still warm
    assert counts["load"] == si._SESSION_CAP + 1
    _run(model_and_case, "cap_first", batch_size=1)  # dropped: built again
    assert counts["load"] == si._SESSION_CAP + 2


def test_int8_calibration_runs_once(model_and_case, counts):
    _, _, case = model_and_case
    kw = dict(quant="int8", calib_image=case, dtype=torch.bfloat16)
    a = _run(model_and_case, "i1", **kw)
    b = _run(model_and_case, "i2", **kw)
    assert (counts["load"], counts["build"], counts["calib"]) == (1, 1, 1)
    np.testing.assert_array_equal(a, b)


def test_failed_build_leaves_no_session(model_and_case, counts, monkeypatch):
    """A request whose build fails caches nothing and closes its prepared
    read-ahead; the next call builds and runs."""
    d, model_dir, case = model_and_case
    build = si.build_forward

    def broken(*a, **kw):
        raise RuntimeError("build exploded")
    monkeypatch.setattr(si, "build_forward", broken)
    prep = si.prepare_cases(case, device="cpu")
    with pytest.raises(RuntimeError, match="build exploded"):
        si.segmentation(case, model_dir, os.path.join(d, "f1"), device="cpu",
                        prepared=prep)
    assert si._SESSIONS == {}
    assert not prep.reader._ut.is_alive() and not prep.reader._dt.is_alive()
    monkeypatch.setattr(si, "build_forward", build)
    _run(model_and_case, "f2")
    assert len(si._SESSIONS) == 1


def _run_c2f(model_and_case, tag, **kw):
    d, model_dir, case = model_and_case
    out = os.path.join(d, tag)
    res = c2f.segmentation_coarse_to_fine(
        case, model_dir, model_dir, out, partition_size=(16, 16, 16),
        batch_size=2, device="cpu", **kw)
    return read_image(os.path.join(out, res[0][0], "seg.mha")).data


def test_c2f_session_cache(model_and_case, counts):
    """Coarse and fine models and forwards are built once per session and
    the coarse inferers persist in it; another option is another session,
    at most two are kept, the oldest dropped first."""
    first = _run_c2f(model_and_case, "c1")
    assert (counts["load"], counts["build"]) == (2, 2)  # coarse + fine
    second = _run_c2f(model_and_case, "c2")
    assert (counts["load"], counts["build"]) == (2, 2)
    np.testing.assert_array_equal(first, second)
    sess = next(iter(c2f._C2F_SESSIONS.values()))
    assert len(sess["coarse_inferers"]) == 1
    _run_c2f(model_and_case, "c3", tta="x")
    _run_c2f(model_and_case, "c4", margin_mm=8.0)  # not a session option
    assert counts["load"] == 4 and len(c2f._C2F_SESSIONS) == 2
    _run_c2f(model_and_case, "c5", blend="constant")
    assert counts["load"] == 6 and len(c2f._C2F_SESSIONS) == 2
    _run_c2f(model_and_case, "c6")  # the first session was dropped
    assert counts["load"] == 8


def test_c2f_int8_calibration_runs_once(model_and_case, counts):
    _, _, case = model_and_case
    kw = dict(quant="int8", calib_image=case, dtype=torch.bfloat16)
    _run_c2f(model_and_case, "ci1", **kw)
    _run_c2f(model_and_case, "ci2", **kw)
    assert (counts["load"], counts["calib"]) == (2, 1)
