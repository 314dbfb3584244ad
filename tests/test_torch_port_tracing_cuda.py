"""The program's spans on the device trace's clock, on a CUDA device.
Imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=. python -m pytest --noconftest -m cuda tests/test_torch_port_tracing_cuda.py -s

``segmentation()`` on three cases under ``torch.profiler`` (CPU and CUDA
activities): each case's ``infer.upload`` span runs on the read-ahead's
upload thread, not the profiling thread, and ends by waiting for its
host-to-device copy. Mapped to the trace's clock by the buffer's offset,
its end must fall within 1 ms after the end of that copy on the device.
"""
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from segmentation3d_tpu_torch.core.seg_infer import segmentation
from segmentation3d_tpu_torch.io import Volume, write_image
from segmentation3d_tpu_torch.models.vnet import SegmentationNet
from segmentation3d_tpu_torch.ops.geometry import Frame
from segmentation3d_tpu_torch.utils import model_io, tracing
from segmentation3d_tpu_torch.utils.normalizer import FixedNormalizer

KW = dict(base_channels=4, down_convs=(1, 1), up_convs=(1, 1))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the device trace has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_upload_spans_end_with_their_copies_on_the_trace_clock(tmp_path, cuda_device):
    torch.manual_seed(0)
    net = SegmentationNet(1, 2, **KW)
    model = str(tmp_path / "model")
    model_io.save_checkpoint(model, 0, 0, net.state_dict(), "vnet", 4, 1, 2,
                             [1.0, 1.0, 1.0], "LINEAR",
                             [FixedNormalizer(mean=0.0, stddev=1.0)],
                             extra={"net_kwargs": dict(KW)})
    folder = tmp_path / "in"
    folder.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        img = rng.normal(0.0, 1.0, (96, 160, 160)).astype(np.float32)
        write_image(Volume(img, Frame.identity()), str(folder / f"case{i}.mha"))
    kw = dict(device=cuda_device, batch_size=4, shape_bucket=16,
              partition_type="SIZE", partition_size=[64, 64, 64])
    segmentation(str(folder), model, str(tmp_path / "warm"), **kw)
    tracing.take()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        segmentation(str(folder), model, str(tmp_path / "out"), **kw)
        torch.cuda.synchronize()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    taken = tracing.take()
    with open(path) as f:
        trace = json.load(f)
    base = trace["baseTimeNanoseconds"]
    size = 96 * 160 * 160 * 4  # one case's float32 voxels
    copies = sorted((e["ts"] + e["dur"]) * 1e3 + base for e in trace["traceEvents"]
                    if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]
                    and e.get("args", {}).get("bytes", size) == size)
    uploads = [s for s in taken.spans if s.name == "infer.upload"]
    main = [s for s in taken.spans if s.name == "infer.call"][0]
    assert len(uploads) == 3 and copies
    gaps = []
    for s in uploads:
        assert s.thread == "read-ahead-upload" and s.tid != main.tid
        end = s.t1 + taken.offset_ns
        before = [c for c in copies if c <= end + 2e5]
        assert before, "no host-to-device copy ended before the upload span"
        gaps.append((end - before[-1]) / 1e6)
    print(f"upload span end less its copy's end, ms: {gaps}")
    assert all(-0.2 < g < 1.0 for g in gaps), gaps
    os.remove(path)
