"""The port's host spans and counters (``utils/tracing.py``) on the CPU.

The module alone (off, on across threads, the cap, the clock shared with
the profiler's Chrome trace), then the three instrumented places: the case
loop of ``segmentation()``, a server's requests across its threads, and
``train()`` with its data stage and its ``debug.profile_dir`` trace. Tracing
is on exactly while a ``torch.profiler`` records; results must not change
with it.
"""
import functools
import gc
import json
import os
import threading
import time
import weakref

import numpy as np
import pytest
import torch
from torch.autograd.profiler import record_function
from torch.profiler import ProfilerActivity, profile

from crop_boxes import box_voxels
from phantoms import make_sphere_case, make_train_list, write_train_config
from segmentation3d_tpu_torch.core import seg_infer, seg_train
from segmentation3d_tpu_torch.core.seg_infer import prepare_cases, segmentation
from segmentation3d_tpu_torch.core.serve import SegmentationServer, request, serve_forever
from segmentation3d_tpu_torch.dataloader import SegmentationDataset
from segmentation3d_tpu_torch.io import Volume, read_image, write_image
from segmentation3d_tpu_torch.models.vnet import SegmentationNet
from segmentation3d_tpu_torch.ops.geometry import Frame
from segmentation3d_tpu_torch.utils import model_io, tracing
from segmentation3d_tpu_torch.utils.normalizer import FixedNormalizer

KW = dict(base_channels=4, down_convs=(1, 1), up_convs=(1, 1))
CASE_SPANS = ("infer.decode", "infer.upload", "infer.read_wait", "infer.enqueue",
              "infer.write_wait", "infer.materialize", "infer.write")


@pytest.fixture(autouse=True)
def empty_buffer():
    tracing.take()
    yield
    tracing.take()


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _by(spans, **match):
    return [s for s in spans if all(getattr(s, k) == v for k, v in match.items())]


# --------------------------------------------------------------------------
# the module
# --------------------------------------------------------------------------

def test_nothing_is_recorded_when_off():
    assert not tracing.enabled()
    with tracing.span("a", case=1) as a:
        time.sleep(0.002)
    b = tracing.begin("b")
    b.end()
    tracing.count("c", 5)
    assert a.seconds >= 0.002 and b.seconds >= 0 and a.id is None
    taken = tracing.take()
    assert taken.spans == [] and taken.counters == {} and taken.offset_ns is None


def test_spans_of_three_threads_keep_parent_id_and_thread():
    def work(within, case):
        with tracing.span("work", case, within):
            with tracing.span("inner", case):
                pass

    with _profiled():
        assert tracing.enabled()
        with tracing.bound(tracing.Context(None, 77)):
            with tracing.span("root") as root:
                within = tracing.context()
                threads = [threading.Thread(target=work, args=(within, 10 + i),
                                            name=f"worker-{i}") for i in range(3)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(30)
                    assert not t.is_alive()
        tracing.count("things", 2)
        tracing.count("things")
    taken = tracing.take()
    assert taken.counters == {"things": 3} and taken.offset_ns is not None
    (rec,) = _by(taken.spans, name="root")
    assert rec.id == root.id and rec.parent is None and rec.request == 77
    assert rec.thread == threading.current_thread().name
    work_spans = _by(taken.spans, name="work")
    assert sorted(s.case for s in work_spans) == [10, 11, 12]
    assert {s.thread for s in work_spans} == {"worker-0", "worker-1", "worker-2"}
    assert len({s.tid for s in work_spans} | {rec.tid}) == 4
    for s in work_spans:
        assert s.parent == root.id and s.request == 77 and s.t1 >= s.t0
        (inner,) = _by(taken.spans, name="inner", case=s.case)
        assert inner.parent == s.id and inner.tid == s.tid
        assert inner.request is None  # a worker's own thread carries no request


def test_the_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "CAP", 3)
    with _profiled():
        for i in range(5):
            with tracing.span("s", case=i):
                pass
    taken = tracing.take()
    assert [s.case for s in taken.spans] == [0, 1, 2]
    assert taken.counters == {"tracing.dropped": 2}


def test_a_worker_span_meets_the_profiler_on_its_clock(tmp_path):
    """A span started on a worker thread, mapped by the buffer's offset,
    starts within 1 ms of a record_function opened at the same moment on
    the profiling thread (``ts`` plus ``baseTimeNanoseconds``)."""
    go, done = threading.Event(), threading.Event()
    started = []

    def worker():
        for _ in range(5):
            go.wait(30)
            go.clear()
            started.append(tracing.begin("worker.probe"))
            started[-1].end()
            done.set()

    path = str(tmp_path / "trace.json")
    t = threading.Thread(target=worker)
    t.start()
    with _profiled() as prof:
        with record_function("warm"):
            pass
        for i in range(5):
            with record_function(f"main.probe{i}"):
                go.set()
                assert done.wait(30)
                done.clear()
    t.join(30)
    assert not t.is_alive()
    prof.export_chrome_trace(path)
    taken = tracing.take()
    with open(path) as f:
        trace = json.load(f)
    base = trace["baseTimeNanoseconds"]
    starts = {e["name"]: e["ts"] * 1e3 + base for e in trace["traceEvents"]
              if e.get("name", "").startswith("main.probe")}
    gaps = [abs(s.t0 + taken.offset_ns - starts[f"main.probe{i}"]) / 1e6
            for i, s in enumerate(_by(taken.spans, name="worker.probe"))]
    assert len(gaps) == 5 and min(gaps) < 1.0, gaps


# --------------------------------------------------------------------------
# the case loop
# --------------------------------------------------------------------------

def _tiny_model(model_dir, seed=0):
    torch.manual_seed(seed)
    net = SegmentationNet(1, 2, **KW)
    model_io.save_checkpoint(model_dir, 0, 0, net.state_dict(), "vnet", 4, 1, 2,
                             [1.0, 1.0, 1.0], "LINEAR",
                             [FixedNormalizer(mean=0.0, stddev=1.0)],
                             extra={"net_kwargs": dict(KW)})
    return model_dir


def _noise_case(path, shape, seed):
    img = np.random.default_rng(seed).normal(0.0, 1.0, shape).astype(np.float32)
    write_image(Volume(img, Frame.identity()), path)
    return path


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    root = tmp_path_factory.mktemp("tracing")
    model = _tiny_model(str(root / "model"))
    folder = root / "in"
    folder.mkdir()
    for i, shape in enumerate([(20, 24, 22), (24, 20, 20), (22, 22, 24)]):
        _noise_case(str(folder / f"case{i}.nii.gz"), shape, seed=i)
    return root, str(folder), model


def _masks(out, names):
    return {n: read_image(os.path.join(out, n, "seg.nii.gz")).data for n in names}


def test_the_case_loop_under_the_profiler(cases):
    root, folder, model = cases
    kw = dict(device="cpu", batch_size=1, shape_bucket=16, seg_name="seg.nii.gz")
    plain = segmentation(folder, model, str(root / "off"), **kw)
    with _profiled():
        traced = segmentation(folder, model, str(root / "on"), **kw)
    taken = tracing.take()
    names = [r[0] for r in plain]
    assert names == [r[0] for r in traced] == ["case0", "case1", "case2"]
    on, off = _masks(str(root / "on"), names), _masks(str(root / "off"), names)
    for n in names:
        np.testing.assert_array_equal(on[n], off[n])

    (call,) = _by(taken.spans, name="infer.call")
    ids = sorted({s.case for s in taken.spans if s.name == "infer.decode"})
    assert len(ids) == 3
    for (name, _, stages), cid in zip(traced, ids):
        spans = _by(taken.spans, case=cid)
        assert sorted(s.name for s in spans) == sorted(CASE_SPANS), name
        one = {s.name: s for s in spans}
        assert stages["read"] == one["infer.decode"].seconds + one["infer.upload"].seconds
        assert stages["write"] == one["infer.write"].seconds
        for n in ("infer.read_wait", "infer.enqueue", "infer.write_wait",
                  "infer.decode", "infer.upload"):
            assert one[n].parent == call.id, n
        assert one["infer.materialize"].parent == one["infer.enqueue"].id
        assert one["infer.write"].parent == one["infer.enqueue"].id
        assert one["infer.enqueue"].tid == call.tid != one["infer.decode"].tid
    (drain,) = _by(taken.spans, name="infer.drain")
    assert drain.parent == call.id and drain.case is None


def test_a_case_upload_goes_before_the_next_case_runs(cases, monkeypatch):
    """The loop holds a case's uploaded voxels only until the next case
    arrives: with the read-ahead's queue full, one more would stay on the
    device for each case in flight."""
    root, folder, model = cases
    log, uploaded, enqueued = [], [0], [0]
    upload, one_case = seg_infer._upload, seg_infer.segmentation_one_case

    def traced_upload(data, device):
        t = upload(data, device).clone()
        k, uploaded[0] = uploaded[0], uploaded[0] + 1
        weakref.finalize(t, lambda: log.append((k, enqueued[0])))
        return t

    def counted(*a, **kw):
        enqueued[0] += 1
        return one_case(*a, **kw)

    monkeypatch.setattr(seg_infer, "_upload", traced_upload)
    monkeypatch.setattr(seg_infer, "segmentation_one_case", counted)
    segmentation(folder, model, str(root / "freed"), device="cpu", batch_size=1,
                 shape_bucket=16)
    gc.collect()
    # case k's upload is freed while k + 1 cases have been enqueued
    assert sorted(log) == [(k, k + 1) for k in range(3)], log


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def test_a_request_id_follows_each_request_across_the_server(cases):
    root, folder, model = cases
    case = os.path.join(folder, "case1.nii.gz")

    def run_fn(input_path, output_dir, seg_name, save_image, save_prob, prepared=None):
        return segmentation(input_path, model, output_dir, seg_name=seg_name,
                            batch_size=1, shape_bucket=16, device="cpu",
                            prepared=prepared)

    server = SegmentationServer(run_fn, model, seg_name="seg.nii.gz")
    sock = str(root / "trace.sock")
    t = threading.Thread(target=serve_forever, daemon=True, name="serve-exec",
                         kwargs=dict(server=server, socket_path=sock, log=None,
                                     prep_fn=lambda req: prepare_cases(req["input"],
                                                                       device="cpu")))
    t.start()
    for _ in range(400):
        if os.path.exists(sock):
            break
        t.join(0.05)
    answers = {}

    def client(k):
        answers[k] = request(sock, {"input": case, "output_dir": str(root / f"r{k}")})

    try:
        with _profiled():
            clients = [threading.Thread(target=client, args=(k,)) for k in range(2)]
            for c in clients:
                c.start()
            for c in clients:
                c.join(60)
                assert not c.is_alive()
    finally:
        request(sock, {"cmd": "shutdown"}, timeout=30)
        t.join(30)
    assert not t.is_alive()
    assert all(a["ok"] for a in answers.values()), answers
    taken = tracing.take()
    pendings = _by(taken.spans, name="serve.pending")
    assert len(pendings) == 2 and len({p.request for p in pendings}) == 2
    for pending in pendings:
        spans = {s.name: s for s in _by(taken.spans, request=pending.request)}
        assert set(spans) >= {"serve.pending", "serve.exec", "infer.call",
                              *CASE_SPANS, "infer.drain"}
        assert spans["serve.pending"].thread.startswith("serve-reader")
        assert spans["serve.exec"].thread == "serve-exec"
        # the read-ahead started on the prep thread
        assert spans["infer.decode"].thread.startswith("read-ahead")
        assert spans["infer.upload"].thread == "read-ahead-upload"
        assert spans["infer.write"].thread == "write-behind-write"
        assert spans["serve.pending"].parent is spans["serve.exec"].parent is None
        assert spans["infer.decode"].parent is None
        assert spans["infer.call"].parent == spans["serve.exec"].id
        assert spans["serve.pending"].t1 <= spans["serve.exec"].t0
    secs = sorted(a["secs"] for a in answers.values())
    execs = sorted(round(s.seconds, 3) for s in _by(taken.spans, name="serve.exec"))
    assert secs == execs


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def train_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_tracing")
    d = str(root / "data")
    return root, [make_sphere_case(d, f"c{i}", shape_zyx=(24, 26, 22),
                                   spacing=(1.1, 0.9, 1.2), seed=i) for i in range(2)]


def _train_config(root, name, cases, extra=""):
    lst = make_train_list(str(root / f"{name}.txt"), cases)
    net = "".join(f"__C.net.{k} = {v!r}\n" for k, v in KW.items())
    return write_train_config(str(root / f"{name}.py"), lst, str(root / name),
                              crop_size=(16, 16, 16), epochs=3, batchsize=2,
                              save_epochs=10, sampling_method="MASK",
                              extra=net + extra)


def _losses(root, name):
    with open(os.path.join(str(root), name, "train_loss.csv")) as f:
        return [line.split(",")[2] for line in f.read().split()[1:]]


@pytest.mark.parametrize("cache_gb", [0.0, None])
def test_train_counts_the_crops_its_cache_misses(train_data, monkeypatch, cache_gb):
    root, data = train_data
    tag = "nocache" if cache_gb == 0.0 else "cache"
    crops = []

    class Recorded(SegmentationDataset):
        def __getitem__(self, idx):
            item = super().__getitem__(idx)
            crops.append((self.cases[idx], item[2]))
            return item

    monkeypatch.setattr(seg_train, "SegmentationDataset", functools.partial(
        Recorded, **({} if cache_gb is None else dict(device_cache_gb=cache_gb))))
    off, on = {}, {}
    seg_train.train(_train_config(root, f"{tag}_off", data), gpu_id=-1, stats=off)
    crops.clear()
    with _profiled():
        seg_train.train(_train_config(root, f"{tag}_on", data), gpu_id=-1, stats=on)
    taken = tracing.take()
    assert _losses(root, f"{tag}_off") == _losses(root, f"{tag}_on")
    assert on["steps"] == off["steps"] == 3
    steps = _by(taken.spans, name="train.step")
    batches = _by(taken.spans, name="train.batch")
    waits = _by(taken.spans, name="train.batch_wait")
    assert len(steps) == len(batches) == 3 and len(waits) >= 3
    assert on["prefetch_wait_seconds"] == pytest.approx(
        sum(s.seconds for s in waits), rel=1e-9)
    (call,) = _by(taken.spans, name="train.call")
    assert {s.parent for s in steps + waits + batches} == {call.id}
    assert {s.thread for s in batches} == {"batch-prefetch"}
    (point,) = _by(taken.spans, name="train.save_point")
    assert on["save_point_seconds"] == [point.seconds]
    if cache_gb == 0.0:
        # each miss uploads its crop's source box: float32 voxels, int32 labels
        assert taken.counters["train.stage_miss"] == len(crops) == 3 * 2
        assert taken.counters["train.stage_bytes"] == sum(
            4 * box_voxels(v.frame, v.data.shape, frame, (16, 16, 16))
            for case, frame in crops for v in (case.images[0], case.seg))
    else:
        assert "train.stage_miss" not in taken.counters
        assert "train.stage_bytes" not in taken.counters


def test_profile_dir_trace_holds_the_prefetcher_spans(train_data):
    root, data = train_data
    cfg = _train_config(root, "profiled", data,
                        extra=f"__C.debug.profile_dir = r'{root / 'prof'}'\n")
    seg_train.train(cfg, gpu_id=-1)
    with open(root / "prof" / "trace.json") as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    loop = threading.get_native_id()
    batches = [e for e in events if e.get("cat") == "program_span"
               and e["name"] == "train.batch"]
    assert len(batches) == 3 and all(e["tid"] != loop for e in batches)
    names = {e["tid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert names[batches[0]["tid"]] == "batch-prefetch"
    assert {e["name"] for e in events if e.get("cat") == "program_span"} >= {
        "train.step", "train.batch_wait", "train.batch", "train.save_point"}
    # on the trace's clock, to 1 ms: each of the loop's spans lies inside
    # the profiler's own event of the same name (the span reads its clock
    # after the event opens and before it closes; the profiler's op
    # releases the GIL, so a start may lag by another thread's turn, 1.1-6.9
    # ms in 12 of 90 runs under six parallel processes), and the closest
    # starts meet, which holds the clock offset
    for name in ("train.step", "train.batch_wait"):
        ours = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                      if e.get("cat") == "program_span" and e["name"] == name)
        theirs = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                        if e.get("cat") == "user_annotation" and e["name"] == name)
        assert len(ours) == len(theirs) >= 3
        assert all(t0 - 1e3 <= o0 <= o1 <= t1 + 1e3
                   for (o0, o1), (t0, t1) in zip(ours, theirs)), (ours, theirs)
        assert min(abs(o0 - t0) for (o0, _), (t0, _) in zip(ours, theirs)) < 1e3
    assert "programCounters" in trace
