"""How the numbers are taken: the tail over every request, idle time from
the union of device intervals, rates over the whole window, the result's
keys, and the whole-name import check."""
import json
import subprocess
import sys

import pytest
import torch

from portbench import devtrace, readers, run
from portbench.drivers.serve import percentile
from portbench.manifest import ROOT


def test_p90_is_over_every_request_by_nearest_rank():
    values = list(range(1, 101))  # 100 requests
    assert percentile(values, 90) == 90
    # medians of chunks would hide a slow tail that one chunk holds
    skewed = [1.0] * 85 + [9.0] * 15
    assert percentile(skewed, 90) == 9.0
    assert percentile([3.0], 90) == 3.0


def _trace(tmp_path, device, window=(0.0, 100.0), host=()):
    ev = [{"cat": "user_annotation", "name": devtrace.WINDOW, "ts": window[0],
           "dur": window[1] - window[0]}]
    ev += [{"cat": "kernel", "name": n, "ts": a, "dur": b - a} for a, b, n in device]
    ev += [{"cat": "cpu_op", "name": n, "ts": a, "dur": b - a} for a, b, n in host]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return devtrace.Trace(str(path))


def test_idle_is_the_window_less_the_union_of_device_intervals(tmp_path):
    # two streams overlap in 10..30; the union is 10..40 and 60..70
    tr = _trace(tmp_path, [(10, 30, "a"), (20, 40, "b"), (60, 70, "a")],
                host=[(40, 60, "aten::copy_"), (0, 100, "outer")])
    assert tr.busy_s == pytest.approx(40e-6)
    assert tr.window_s == pytest.approx(100e-6)
    assert readers.idle_share({"trace": tr}) == pytest.approx(60.0)
    gaps = tr.idle_gaps(10)
    assert gaps[0][1] == pytest.approx(30e-6)          # 70..100, the longest
    assert [g[0] for g in gaps if g[1] == pytest.approx(20e-6)] == ["aten::copy_"]
    assert dict(tr.top_ops())["a"] == pytest.approx(30e-6)


def test_intervals_outside_the_window_do_not_count(tmp_path):
    tr = _trace(tmp_path, [(-50, 10, "a"), (90, 150, "b")])
    assert tr.busy_s == pytest.approx(20e-6)


def test_mfu_and_roofline_read_nothing_without_a_trace():
    assert readers.mfu({"trace": None, "peak": {"bf16_flops": 1.0}}, 5.0) is None
    assert readers.thin_conv_roofline({"trace": None}) is None
    assert readers.median_stage({"results": []}, "read") is None


def test_result_line_keys(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")

    class Cell:
        entry = {"chips": 1}
        end_to_end = [{"name": "volumes_per_min", "unit": "volumes/min"},
                      {"name": "setup_s", "unit": "s"}]
        per_layer = []

    res = {"correct": True, "attempted": 8, "failed": 0, "memory_peak_bytes": 5,
           "e2e": {"volumes_per_min": 100.0, "setup_s": 20.0},
           "checks": [("mask_gap", 0.01, 0.05)]}
    out = run.result_line(Cell, res, False)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["device"] == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                             "count": 1, "memory_peak_bytes": 5}
    assert out["metrics"]["volumes_per_min"] == {"value": 100.0, "unit": "volumes/min"}
    assert out["checks"] == {"mask_gap": {"value": 0.01, "limit": 0.05}}


def test_banned_modules_are_compared_by_whole_top_level_name():
    assert run.leaked_modules(["segmentation3d_tpu_torch.core", "jaxtyping", "flaxen"]) == []
    assert run.leaked_modules(["segmentation3d_tpu.ops", "jaxlib.xla", "optax"]) == \
        ["jaxlib", "optax", "segmentation3d_tpu"]


def _imports(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_harness_and_its_drivers_load_no_jax():
    mods = _imports(
        "import json, sys; import portbench.run, portbench.control; "
        "import portbench.drivers.infer, portbench.drivers.serve, portbench.drivers.train; "
        "from segmentation3d_tpu_torch.core import seg_infer, seg_train; "
        "from segmentation3d_tpu_torch.cli import seg_serve; "
        "print(json.dumps(sorted(sys.modules)))")
    assert run.leaked_modules(mods) == []


def test_the_reference_imports_nothing_of_the_program():
    mods = _imports(
        "import json, sys; import portbench.reference.nets, portbench.reference.pipeline, "
        "portbench.reference.train_ref, portbench.reference.lowp; "
        "print(json.dumps(sorted(sys.modules)))")
    tops = {m.split('.')[0] for m in mods}
    assert not tops & {"segmentation3d_tpu_torch", "segmentation3d_tpu", "jax", "flax"}
