"""The readers of the program's spans and counters, on synthetic buffers:
what each metric sums or takes the median of, and nothing read (None, no
error) where the program has no buffer or recorded nothing."""
import importlib.util
import os

import pytest

from portbench import spans
from portbench.manifest import HERE
from segmentation3d_tpu_torch.utils.tracing import Record, Taken

MS = 1_000_000  # ns


def _span(name, t0_ms, t1_ms, case=None, request=None, sid=[0]):
    sid[0] += 1
    return Record(name, t0_ms * MS, t1_ms * MS, sid[0], None, case, request, 1, "t")


def _read(metric, run):
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def _run(records, counters=None):
    return {spans.KEY: Taken(records, counters or {}, 0)}


def test_infer_readers():
    run = _run([
        _span("infer.call", 0, 1000),
        _span("infer.read_wait", 0, 200, case=1), _span("infer.read_wait", 300, 400, case=2),
        _span("infer.read_wait", 900, 910),
        _span("infer.write_wait", 500, 550, case=2), _span("infer.drain", 910, 1000),
        _span("infer.decode", 0, 150, case=1), _span("infer.decode", 10, 310, case=2),
        _span("infer.decode", 20, 520, case=3),
        _span("infer.upload", 150, 170, case=1), _span("infer.upload", 310, 350, case=2),
    ])
    assert _read("infer.read_wait_share", run) == pytest.approx(31.0)
    assert _read("infer.write_wait_share", run) == pytest.approx(14.0)
    assert _read("infer.decode_s", run) == pytest.approx(0.3)
    assert _read("infer.upload_s", run) == pytest.approx(0.03)


def test_train_readers():
    batches = [_span("train.batch", 0, t) for t in (100, 300, 200, 400)]
    steps = [_span("train.step", 0, 5) for _ in range(3)]
    run = _run(batches + steps, {"train.stage_bytes": 3_000_000_000, "train.stage_miss": 6})
    assert _read("train.batch_s", run) == pytest.approx(0.25)
    assert _read("train.stage_mb_per_step", run) == pytest.approx(1000.0)
    # a cache that held every case counts nothing: zero bytes a step
    assert _read("train.stage_mb_per_step", _run(steps)) == 0.0


def test_serve_readers():
    run = _run([
        _span("serve.pending", 0, 400, request=7), _span("serve.pending", 0, 600, request=8),
        _span("serve.pending", 0, 900, request=9),
        _span("infer.drain", 10, 210, request=7), _span("infer.drain", 0, 100, request=8),
        _span("infer.drain", 0, 150, request=9),
        _span("infer.drain", 0, 50),  # not a request's: left out
    ])
    assert _read("serve.pending_s", run) == pytest.approx(0.6)
    assert _read("serve.drain_s", run) == pytest.approx(0.15)


NEW = ["infer.read_wait_share", "infer.write_wait_share", "infer.decode_s", "infer.upload_s",
       "train.batch_s", "train.stage_mb_per_step", "serve.pending_s", "serve.drain_s"]


@pytest.mark.parametrize("metric", NEW)
def test_nothing_to_read_is_none(metric):
    assert _read(metric, {spans.KEY: None}) is None  # a program without tracing
    assert _read(metric, _run([])) is None           # a window with no span


def test_the_buffer_is_taken_once_per_run():
    from segmentation3d_tpu_torch.utils import tracing
    tracing.take()
    run = {}
    assert spans.taken(run) is spans.taken(run)
    assert spans.taken(run).spans == []
