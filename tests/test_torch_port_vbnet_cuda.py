"""The folded VB-Net forward on a CUDA device: against the float32 module,
replayed from CUDA graphs against the same forward run eagerly, and its
``thin_conv3d`` launches against the traced kernels. Imports no JAX:

    PYTHONPATH=. python -m pytest --noconftest -m cuda tests/test_torch_port_vbnet_cuda.py

A full-width VB-Net (base 16, chains (1, 2, 3, 3) and (3, 3, 2, 1)) runs 16
``thin_conv3d`` a batch: the stem, the head and the 14 mid convs of 8, 32
and 64 channels (those of 16 run on cuDNN).
"""
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from segmentation3d_tpu_torch.core.infer_engine import SlidingWindowInferer
from segmentation3d_tpu_torch.models.fused_vnet import build_fused_forward
from segmentation3d_tpu_torch.models.vnet import SegmentationNet
from segmentation3d_tpu_torch.ops import thin_conv as tc
from segmentation3d_tpu_torch.utils import tracing
from segmentation3d_tpu_torch.utils.device import no_tf32
from test_torch_port_graph_forward_cuda import PATCH, STRIDE, _probs, _volume

#: the smoke's agreement bar (chip_smoke.py AGREE_MIN)
AGREE_MIN = 0.98
LAUNCHES_PER_BATCH = 16


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and the hand-written kernel)")
    return torch.device("cuda")


@pytest.fixture
def vbnet(cuda_device):
    torch.manual_seed(0)
    net = SegmentationNet(1, 2, bottleneck=True).eval()
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    return net.to(cuda_device)


@pytest.mark.cuda
def test_folded_vbnet_matches_the_f32_module(vbnet, cuda_device):
    x = torch.randn((2, 96, 96, 96, 1), generator=torch.Generator().manual_seed(1))
    x = x.to(cuda_device)
    with torch.inference_mode(), no_tf32():
        want = vbnet(x)
    fused = build_fused_forward(vbnet)
    assert fused.capturable
    before = tc.thin_conv3d.launches
    got = fused(x)
    torch.cuda.synchronize()
    assert tc.thin_conv3d.launches - before == LAUNCHES_PER_BATCH
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    assert agree >= AGREE_MIN
    assert (got - want).abs().max().item() < 0.1


@pytest.mark.cuda
def test_graphs_equal_eager_bitwise_at_batch_8_and_4(vbnet, cuda_device):
    fused = build_fused_forward(vbnet)

    def eager(x):
        return fused(x)
    graphed = SlidingWindowInferer(fused, PATCH, 2, batch_size=8)
    plain = SlidingWindowInferer(eager, PATCH, 2, batch_size=8)
    vol = _volume(352, cuda_device, 1)  # batches of 8, 8, 4
    want = _probs(plain, vol)
    for _ in range(3):  # first call: 8 eager, 8 captured, 4 eager; then all replayed
        assert torch.equal(_probs(graphed, vol), want)
    assert {k[0] for k, g in graphed._graphs[vol.device].graphs.items()
            if g is not None} == {8, 4}


@pytest.mark.cuda
def test_launch_count_equals_the_traced_kernels(vbnet, cuda_device, tmp_path):
    graphed = SlidingWindowInferer(build_fused_forward(vbnet), PATCH, 2, batch_size=8)
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
    assert launches == 3 * LAUNCHES_PER_BATCH
    assert len(kernels) == launches
    assert counters.get("infer.graph_replays") == 3
    assert not any(e.get("cat") == "kernel" and "bn_fw_inf" in e["name"] for e in events)
