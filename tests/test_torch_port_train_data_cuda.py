"""Training crops read from their source box, on a CUDA device. Imports no
JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=. python -m pytest --noconftest -m cuda tests/test_torch_port_train_data_cuda.py

A 512×512×352 volume at 0.7×0.7×1.25 mm, 96³ crops at 1 mm: the crop from
the box equals the crop of the whole volume on both of the data stage's
paths (a view of the resident volume, a box uploaded from the host), labels
bit for bit and images within float32 summation order; a cache miss uploads
at most 15 MB, and a batch is the same with the device cache on or off.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from crop_boxes import box_voxels
from segmentation3d_tpu_torch.dataloader import SegmentationDataset
from segmentation3d_tpu_torch.io import Volume, write_image
from segmentation3d_tpu_torch.ops.geometry import Frame
from segmentation3d_tpu_torch.ops.resample import crop_at_world_center, source_box
from segmentation3d_tpu_torch.utils import tracing

SHAPE = (352, 512, 512)
FRAME = Frame.identity((0.7, 0.7, 1.25), origin=(-180.0, -175.0, -220.0))
CROP, SPACING = (96, 96, 96), (1.0, 1.0, 1.0)


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the data stage's device path)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def volumes(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    image = torch.randn(SHAPE, generator=gen, device=cuda_device)
    seg = torch.randint(0, 3, SHAPE, generator=gen, device=cuda_device,
                        dtype=torch.int32)
    return image, seg


@pytest.mark.cuda
def test_box_crops_equal_whole_volume_crops_on_both_paths(volumes):
    image, seg = volumes
    host = {"LINEAR": image.cpu().numpy(), "NN": seg.cpu().numpy()}
    rng = np.random.default_rng(1)
    top = np.asarray(SHAPE[::-1], np.float64) - 1.0
    fracs = [(0.5, 0.5, 0.5), (0.0, 0.5, 0.5), (0.5, 1.0, 0.5), (0.5, 0.5, 0.0),
             (0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (1.0, 0.0, 1.0), (-1.0, 0.5, 0.5)]
    for f in fracs + [tuple(rng.uniform(0.0, 1.0, 3)) for _ in range(4)]:
        center = FRAME.index_to_world(np.asarray(f) * top + rng.uniform(-1, 1, 3))
        box = source_box(FRAME, SHAPE, center, CROP, SPACING)
        for interp, whole in (("LINEAR", image), ("NN", seg)):
            want, _ = crop_at_world_center(whole, FRAME, center, CROP, SPACING, interp)
            view, _ = crop_at_world_center(whole[box.slices], FRAME, center, CROP,
                                           SPACING, interp, box=box)
            part = torch.from_numpy(np.ascontiguousarray(host[interp][box.slices]))
            uploaded, _ = crop_at_world_center(part.to(whole.device), FRAME, center,
                                               CROP, SPACING, interp, box=box)
            for got in (view, uploaded):
                if interp == "NN":
                    assert torch.equal(got, want)
                else:
                    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_a_cache_miss_uploads_at_most_15_mb(volumes, cuda_device, tmp_path):
    image, seg = volumes
    im_path, seg_path = str(tmp_path / "im.mha"), str(tmp_path / "seg.mha")
    write_image(Volume(image.cpu().numpy(), FRAME), im_path)
    write_image(Volume((seg.cpu().numpy() > 1).astype(np.uint8), FRAME), seg_path)
    runs = []
    for cache_gb in (0.0, 10.0):
        ds = SegmentationDataset(([[im_path]], [seg_path]), num_classes=2,
                                 spacing=SPACING, crop_size=CROP, sampling_method="MIX",
                                 random_translation=(5.0, 5.0, 5.0), seed=2,
                                 device_cache_gb=cache_gb, device=cuda_device)
        tracing.take()
        with profile(activities=[ProfilerActivity.CPU]):
            batch = ds.batch([0] * 4)
            torch.cuda.synchronize()
        runs.append((ds, batch, tracing.take().counters))
    (ds, (im0, seg0, frames, _), missed), (_, (im1, seg1, _, _), resident) = runs
    case = ds.cases[0]
    boxes = [sum(box_voxels(v.frame, v.data.shape, f, CROP) * 4
                 for v in (case.images[0], case.seg)) for f in frames]
    assert missed["train.stage_miss"] == 4
    assert missed["train.stage_bytes"] == sum(boxes)
    assert max(boxes) <= 15e6 < case.nbytes
    assert "train.stage_miss" not in resident
    torch.testing.assert_close(im1, im0, rtol=1e-6, atol=1e-6)
    assert torch.equal(seg1, seg0)
