"""The engine's CUDA-graph path, on the CPU.

:class:`SlidingWindowInferer` replays a forward marked ``capturable`` from
one CUDA graph per device and batch shape. Here the CUDA pieces are stood
in for (``_capture``, streams, the pool, the device's type), so the
bookkeeping runs on the CPU: which batches run eagerly, which capture and
which replay, the counters, the launch count a replay adds, and that the
static input and output give the eager results bit for bit. The capture
itself runs on the card (``test_torch_port_graph_forward_cuda.py``).
"""
import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from segmentation3d_tpu_torch.core import infer_engine as te
from segmentation3d_tpu_torch.core.seg_infer import module_forward
from segmentation3d_tpu_torch.core.spatial_shard import SpatialShardedInferer
from segmentation3d_tpu_torch.models.fused_vnet import build_fused_forward
from segmentation3d_tpu_torch.models.quant_vnet import build_int8_forward
from segmentation3d_tpu_torch.models.vnet import SegmentationNet
from segmentation3d_tpu_torch.ops import thin_conv as tc
from segmentation3d_tpu_torch.utils import tracing

PATCH, STRIDE = (4, 4, 4), (4, 4, 4)
LAUNCHES = 3  # the stub's kernel launches per forward

#: a CUDA device as the engine sees it (hashable, ``type == "cuda"``)
FakeCuda = collections.namedtuple("FakeCuda", "type index")


class FakeStream:
    def wait_stream(self, other):
        pass


class FakeGraph:
    """Replays by recomputing ``fn(inp)`` into the captured output, while
    the stand-in capture flag is up, so the stub forward counts nothing:
    on the card a replay launches from the graph, not through Python."""

    def __init__(self, fn, inp, out, flag):
        self.fn, self.inp, self.out, self.flag = fn, inp, out, flag

    def replay(self):
        self.flag[0] = True
        try:
            self.out.copy_(self.fn(self.inp))
        finally:
            self.flag[0] = False


@pytest.fixture
def fake_cuda(monkeypatch):
    """The engine's CUDA calls stood in for; ``flag[0]`` is the stand-in
    for ``torch.cuda.is_current_stream_capturing()``."""
    flag, stream = [False], FakeStream()

    def capture(fn, inp, pool, capture_stream):
        before = tc.recorded_launches()
        flag[0] = True
        try:
            out = fn(inp)
        finally:
            flag[0] = False
        return FakeGraph(fn, inp, out, flag), out, tc.recorded_launches() - before

    graphs_on = te.SlidingWindowInferer._graphs_on
    monkeypatch.setattr(te, "_capture", capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None, priority=0: FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: flag[0])
    monkeypatch.setattr(te.SlidingWindowInferer, "_graphs_on",
                        lambda self, f, d: graphs_on(self, f, FakeCuda("cuda", 0)))
    return flag


@pytest.fixture
def no_capture(monkeypatch):
    """The CPU as it is: no stream ever captures."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)


def stub(nc=2, capturable=True):
    """A two-class forward that launches ``LAUNCHES`` kernels a call."""
    def forward(x):
        for _ in range(LAUNCHES):
            tc.count_launch()
        logits = torch.cat([x * (c + 1) - 0.3 * c for c in range(nc)], dim=-1)
        return torch.softmax(logits, dim=-1)
    forward.capturable = capturable
    return forward


def volume(shape, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape + (1,)).astype(np.float32))


def parent_result(inferer, forward, vol, stride):
    """The engine's result as it was computed before the graphs: each box's
    probabilities times a freshly uploaded weight map, pasted one by one."""
    pd, ph, pw = inferer.patch_size
    boxes = inferer.boxes_for(tuple(vol.shape[:3]), stride)
    prob = torch.zeros(tuple(vol.shape[:3]) + (inferer.num_classes,))
    wsum = torch.zeros(tuple(vol.shape[:3]) + (1,))
    weight = torch.from_numpy(te.make_weight_map(inferer.patch_size, inferer.blend))
    for i in range(0, len(boxes), inferer.batch_size):
        bxs = boxes[i:i + inferer.batch_size].tolist()
        probs = inferer._forward(forward, torch.stack(
            [vol[z:z + pd, y:y + ph, x:x + pw] for z, y, x in bxs]))
        for (z, y, x), p in zip(bxs, probs):
            prob[z:z + pd, y:y + ph, x:x + pw] += p * weight
            wsum[z:z + pd, y:y + ph, x:x + pw] += weight
    prob = prob / torch.clamp_min(wsum, 1e-8)
    return torch.argmax(prob, dim=-1).to(torch.uint8), prob


def traced_call(inferer, vol, stride=STRIDE):
    """``inferer(vol)``'s mask and probabilities, and the counters it made."""
    tracing.take()
    with profile(activities=[ProfilerActivity.CPU]):
        mask, prob = inferer(vol, stride_zyx=stride, return_prob=True)
    return mask, prob, tracing.take().counters


def tiny_vnet():
    torch.manual_seed(0)
    return SegmentationNet(1, 2, base_channels=4, down_convs=(1, 1),
                           up_convs=(1, 1)).eval()


@pytest.mark.parametrize("kind", ["capturable_stub", "module"])
@pytest.mark.parametrize("tta", [None, "x"])
def test_a_cpu_forward_runs_eagerly_and_gives_the_parents_result(no_capture, kind, tta):
    forward = stub() if kind == "capturable_stub" else module_forward(tiny_vnet(), torch.float32)
    inferer = te.SlidingWindowInferer(forward, PATCH, 2, batch_size=8, tta=tta)
    vol = volume((20, 8, 8))  # 20 boxes: batches of 8, 8, 4
    mask, prob, counters = traced_call(inferer, vol)
    want_mask, want_prob = parent_result(inferer, forward, vol, STRIDE)
    assert torch.equal(prob, want_prob) and torch.equal(mask, want_mask)
    assert counters == {"infer.graph_eager": 3}
    assert inferer._graphs == {}


def test_only_a_forward_marked_capturable_gets_graphs(fake_cuda):
    vol = volume((20, 8, 8))
    marked = te.SlidingWindowInferer(stub(), PATCH, 2, batch_size=8)
    unmarked = te.SlidingWindowInferer(stub(capturable=False), PATCH, 2, batch_size=8)
    for _ in range(2):
        *_, counters = traced_call(unmarked, vol)
        assert counters == {"infer.graph_eager": 3}
        *_, counters = traced_call(marked, vol)
        assert counters.get("infer.graph_replays", 0) > 0
    assert unmarked._graphs == {}


def test_stats_cpu_int8_and_module_forwards_are_never_marked():
    net = tiny_vnet()
    assert build_fused_forward(net, dtype=torch.float32).capturable is False  # CPU
    assert build_fused_forward(net, dtype=torch.float32, stats=True).capturable is False
    for forward in (build_int8_forward(net), module_forward(net, torch.bfloat16)):
        assert not getattr(forward, "capturable", False)


def test_the_weight_map_is_built_once_per_inferer_and_device(no_capture, monkeypatch):
    built = []

    def counting(*args, **kwargs):
        built.append(args)
        return make(*args, **kwargs)
    make = te.make_weight_map
    monkeypatch.setattr(te, "make_weight_map", counting)
    inferer = te.SlidingWindowInferer(stub(), PATCH, 2, batch_size=8)
    for shape in ((20, 8, 8), (8, 12, 8), (20, 8, 8)):
        inferer(volume(shape), stride_zyx=STRIDE)
    assert len(built) == 1
    sharded = te.SlidingWindowInferer({torch.device("cpu"): stub()}, PATCH, 2,
                                      batch_size=4, devices=["cpu", "cpu"])
    for shape in ((20, 8, 8), (8, 12, 8)):
        sharded(volume(shape), stride_zyx=STRIDE)
    assert len(built) == 2
    assert sharded._weights[torch.device("cpu")] is sharded._weight(torch.device("cpu"))


@pytest.mark.parametrize("tta", [None, "zyx"])
def test_counters_count_captures_replays_and_eager_batches(fake_cuda, tta):
    forward = stub()
    inferer = te.SlidingWindowInferer(forward, PATCH, 2, batch_size=8, tta=tta)
    vol = volume((20, 8, 8))  # batches of 8, 8, 4
    want_mask, want_prob = parent_result(inferer, forward, vol, STRIDE)
    expected = [
        # the 8's first batch eager, its second captured and replayed; the 4 eager
        {"infer.graph_eager": 2, "infer.graph_captures": 1, "infer.graph_replays": 1},
        # the 8's replayed twice; the 4's second batch captured and replayed
        {"infer.graph_captures": 1, "infer.graph_replays": 3},
        {"infer.graph_replays": 3},
    ]
    for want in expected:
        mask, prob, counters = traced_call(inferer, vol)
        assert counters == want
        assert torch.equal(prob, want_prob) and torch.equal(mask, want_mask)
    shapes = {k[0] for k, g in inferer._graphs[FakeCuda("cuda", 0)].graphs.items()
              if g is not None}
    assert shapes == {8, 4}


def test_a_replay_adds_the_launches_its_capture_recorded(fake_cuda):
    inferer = te.SlidingWindowInferer(stub(), PATCH, 2, batch_size=8)
    vol = volume((20, 8, 8))
    recorded = tc.recorded_launches()
    launched = []
    for _ in range(3):
        before = tc.thin_conv3d.launches
        inferer(vol, stride_zyx=STRIDE)
        launched.append(tc.thin_conv3d.launches - before)
    # each batch launches once, eagerly (the 8's and the 4's first) or
    # replayed; the captures launch nothing
    assert launched == [3 * LAUNCHES] * 3
    graphs = inferer._graphs[FakeCuda("cuda", 0)].graphs.values()
    assert [g.launches for g in graphs] == [LAUNCHES, LAUNCHES]
    assert tc.recorded_launches() >= recorded + 2 * LAUNCHES


def test_two_shapes_interleave_through_their_static_buffers(fake_cuda):
    forward = stub()
    inferer = te.SlidingWindowInferer(forward, PATCH, 2, batch_size=8)
    vols = [volume((20, 8, 8), seed=1), volume((12, 8, 8), seed=2)]  # 8,8,4 and 8,4
    wants = [parent_result(inferer, forward, v, STRIDE) for v in vols]
    for i in (0, 1, 1, 0, 1, 0, 0):
        mask, prob = inferer(vols[i], stride_zyx=STRIDE, return_prob=True)
        assert torch.equal(prob, wants[i][1]) and torch.equal(mask, wants[i][0])


def test_shards_capture_per_device_and_match_one_device(fake_cuda):
    vol = volume((20, 8, 8))
    one = te.SlidingWindowInferer(stub(), PATCH, 2, batch_size=2)
    cpu = torch.device("cpu")
    sharded = te.SlidingWindowInferer({cpu: stub()}, PATCH, 2, batch_size=2,
                                      devices=["cpu", "cpu"])
    for _ in range(2):
        m1, p1 = one(vol, stride_zyx=STRIDE, return_prob=True)
        m2, p2 = sharded(vol, stride_zyx=STRIDE, return_prob=True)
        assert torch.equal(m1, m2)
        np.testing.assert_allclose(p1.numpy(), p2.numpy(), atol=1e-6)
    assert list(sharded._graphs) == [FakeCuda("cuda", 0)]


def test_slab_batches_of_one_and_the_spatial_shards_keep_their_masks(fake_cuda):
    vol = volume((24, 8, 8), seed=3)
    patch, stride = (8, 8, 8), (4, 8, 8)
    slab = te.SlidingWindowInferer(stub(), patch, 2, batch_size=1)
    plain = te.SlidingWindowInferer(stub(capturable=False), patch, 2, batch_size=1)
    want = plain(vol, stride_zyx=stride)
    for _ in range(2):
        mask, _, counters = traced_call(slab, vol, stride)
        assert torch.equal(mask, want)
    assert counters == {"infer.graph_replays": 5}
    z_sharded = SpatialShardedInferer(stub(), 8, 2, ["cpu", "cpu"], stride_z=4)
    z_plain = SpatialShardedInferer(stub(capturable=False), 8, 2, ["cpu", "cpu"],
                                    stride_z=4)
    assert torch.equal(z_sharded(vol), z_plain(vol))
