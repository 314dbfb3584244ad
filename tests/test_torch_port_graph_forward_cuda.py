"""The folded V-Net forward replayed from CUDA graphs against the same
forward run eagerly, on a CUDA device. Imports no JAX, so it runs where
only PyTorch is installed:

    PYTHONPATH=. python -m pytest --noconftest -m cuda tests/test_torch_port_graph_forward_cuda.py

The graphs hold the same kernels and ops, in the same order and precisions,
as the eager batch: their probabilities must be bitwise equal. Volumes of
352 x 160 x 160 and 224 x 160 x 160 voxels at 96^3 boxes, stride 64, give
batches of 8, 8, 4 and of 8, 4, the shapes of the benchmark's cases.
"""
import json
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from segmentation3d_tpu_torch.core.infer_engine import SlidingWindowInferer
from segmentation3d_tpu_torch.models.fused_vnet import build_fused_forward
from segmentation3d_tpu_torch.models.vnet import SegmentationNet
from segmentation3d_tpu_torch.ops import thin_conv as tc
from segmentation3d_tpu_torch.utils import tracing

PATCH, STRIDE = (96, 96, 96), (64, 64, 64)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and the hand-written kernel)")
    return torch.device("cuda")


@pytest.fixture
def forwards(cuda_device):
    """The folded forward of a seeded full-width V-Net, and the same forward
    without its ``capturable`` mark (the engine then runs it eagerly)."""
    torch.manual_seed(0)
    net = SegmentationNet(1, 2, base_channels=16, down_convs=(1, 2, 3, 3),
                          up_convs=(3, 3, 2, 1)).eval()
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    fused = build_fused_forward(net.to(cuda_device))
    assert fused.capturable
    assert not build_fused_forward(net, stats=True).capturable

    def eager(x):
        return fused(x)
    return fused, eager


def _volume(depth, device, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((depth, 160, 160, 1), generator=g).to(device)


def _probs(inferer, vol):
    return inferer(vol, stride_zyx=STRIDE, return_prob=True)[1]


@pytest.mark.cuda
@pytest.mark.parametrize("tta", [None, "zyx"])
def test_graphs_equal_eager_bitwise_at_batch_8_and_4(forwards, cuda_device, tta):
    fused, eager = forwards
    graphed = SlidingWindowInferer(fused, PATCH, 2, batch_size=8, tta=tta)
    plain = SlidingWindowInferer(eager, PATCH, 2, batch_size=8, tta=tta)
    vol = _volume(352, cuda_device, 1)  # batches of 8, 8, 4
    want = _probs(plain, vol)
    assert torch.equal(_probs(plain, vol), want)  # the eager forward is deterministic
    for _ in range(3):  # first call: 8 eager, 8 captured, 4 eager; then all replayed
        got = _probs(graphed, vol)
        assert torch.equal(got, want)
    assert {k[0] for k, g in graphed._graphs[vol.device].graphs.items()
            if g is not None} == {8, 4}


@pytest.mark.cuda
def test_replays_of_two_shapes_interleave(forwards, cuda_device):
    fused, eager = forwards
    graphed = SlidingWindowInferer(fused, PATCH, 2, batch_size=8)
    plain = SlidingWindowInferer(eager, PATCH, 2, batch_size=8)
    vols = [_volume(352, cuda_device, 2), _volume(224, cuda_device, 3)]
    wants = [_probs(plain, v) for v in vols]
    for i in (0, 1, 1, 0, 1, 0):
        assert torch.equal(_probs(graphed, vols[i]), wants[i])


@pytest.mark.cuda
def test_capture_while_another_thread_uploads_and_synchronizes(forwards, cuda_device):
    fused, eager = forwards
    stop, errors, copies = threading.Event(), [], [0]

    def upload():
        try:
            while not stop.is_set():
                # a fresh pooled stream each time: the pool hands them out
                # round-robin, so the capture's must not be among them
                stream = torch.cuda.Stream(cuda_device)
                host = torch.randn(1 << 20).pin_memory()
                with torch.cuda.stream(stream):
                    dev = host.to(cuda_device, non_blocking=True)
                    dev.mul_(2.0)
                stream.synchronize()
                copies[0] += 1
        except Exception as e:  # noqa: BLE001 (reported by the test)
            errors.append(e)
    thread = threading.Thread(target=upload)
    thread.start()
    try:
        graphed = SlidingWindowInferer(fused, PATCH, 2, batch_size=8)
        vol = _volume(352, cuda_device, 4)
        got = [_probs(graphed, vol) for _ in range(2)]
    finally:
        stop.set()
        thread.join()
    assert not errors and copies[0] > 0
    want = _probs(SlidingWindowInferer(eager, PATCH, 2, batch_size=8), vol)
    assert all(torch.equal(g, want) for g in got)


@pytest.mark.cuda
def test_launch_count_equals_the_traced_kernels(forwards, cuda_device, tmp_path):
    fused, _ = forwards
    graphed = SlidingWindowInferer(fused, PATCH, 2, batch_size=8)
    vol = _volume(352, cuda_device, 5)
    for _ in range(2):
        _probs(graphed, vol)  # both shapes captured
    torch.cuda.synchronize()
    tracing.take()
    before = tc.thin_conv3d.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _probs(graphed, vol)
        torch.cuda.synchronize()
    launches = tc.thin_conv3d.launches - before
    counters = tracing.take().counters
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"
               and ("conv_direct_kernel" in e["name"] or "conv_wgmma_kernel" in e["name"])]
    assert launches == 3 * 20
    assert len(kernels) == launches
    assert counters.get("infer.graph_replays") == 3
    assert "infer.graph_eager" not in counters and "infer.graph_captures" not in counters
