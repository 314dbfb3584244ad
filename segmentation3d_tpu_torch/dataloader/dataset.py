"""Patch-sampling dataset — crops, normalization and augmentation on the device.

The port of ``segmentation3d_tpu/dataloader/dataset.py`` (``read_train_txt``,
``read_train_csv``, ``_Case``, ``SegmentationDataset``):

- the **host** reads files into numpy (volumes are cached in RAM) and picks
  crop centres (GLOBAL / MASK / CENTER / MIX sampling + world-space
  ``random_translation`` jitter) and every augmentation draw from one numpy
  ``default_rng(seed)``, in the JAX package's order, so a seed gives the
  same crops in both packages;
- the **device** does the fixed-spacing trilinear / NN crop-resample,
  per-modality normalization and the augmentations (flips, in-plane rot90,
  elastic warp, intensity scale and shift, gaussian noise). A crop reads
  only its source box (``ops.resample.source_box``: the smallest index box
  of each volume that holds every voxel its interpolation touches, ~12 MB
  for a 96³ crop at 1 mm of a 0.7×0.7×1.25 mm CT). Whole cases stay on the
  device while they fit ``device_cache_gb`` and are cropped through a view
  of the box; a case beyond it has only the box uploaded, crop by crop.

The gaussian noise comes from a ``torch.Generator`` seeded ``seed + 7`` on
the crop device (the JAX package uses a PRNG key of that seed), never from
the numpy stream, so turning noise on leaves every crop centre as it was.
Each item is ``(image [D,H,W,C] float32, seg [D,H,W] int32, frame, name)``.
"""
from __future__ import annotations

import csv as _csv
import os

import numpy as np
import torch

from segmentation3d_tpu_torch.io import read_image
from segmentation3d_tpu_torch.ops.resample import (LINEAR, NN, crop_at_world_center,
                                                    source_box)
from segmentation3d_tpu_torch.utils import tracing

GLOBAL, MASK, CENTER, MIX = "GLOBAL", "MASK", "CENTER", "MIX"


def read_train_txt(path):
    """txt format: line 0 = case count; then per case ``num_modality`` image
    paths followed by one segmentation path (one path per line)."""
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    num_cases = int(lines[0])
    body = lines[1:]
    if len(body) % num_cases != 0:
        raise ValueError(f"{path}: {len(body)} paths not divisible by {num_cases} cases")
    per_case = len(body) // num_cases
    num_modality = per_case - 1
    ims, segs = [], []
    for i in range(num_cases):
        chunk = body[i * per_case:(i + 1) * per_case]
        ims.append(chunk[:num_modality])
        segs.append(chunk[num_modality])
    return ims, segs


def read_train_csv(path):
    """csv format: header ``image_path,segmentation_path`` (multi-modality:
    several image columns, segmentation last)."""
    ims, segs = [], []
    with open(path, newline="") as f:
        reader = _csv.reader(f)
        next(reader)  # header
        for row in reader:
            row = [c.strip() for c in row if c.strip()]
            if not row:
                continue
            ims.append(row[:-1])
            segs.append(row[-1])
    return ims, segs


def read_case_list(path):
    """``(image paths per case, seg path per case)`` of a .txt or .csv list."""
    return read_train_csv(path) if str(path).endswith(".csv") \
        else read_train_txt(path)


class _Case:
    """Lazy-loaded, RAM-cached case: modality volumes + seg + the foreground
    voxel indices for MASK sampling. :meth:`stage` keeps the voxels on the
    crop device while they fit the dataset's budget, and otherwise uploads
    only each crop's source box."""

    __slots__ = ("im_paths", "seg_path", "images", "seg", "fg_indices", "name",
                 "dev_images", "dev_seg", "nbytes")

    def __init__(self, im_paths, seg_path):
        self.im_paths = list(im_paths)
        self.seg_path = seg_path
        self.images = None
        self.seg = None
        self.fg_indices = None
        self.dev_images = None
        self.dev_seg = None
        self.nbytes = 0
        base = os.path.basename(im_paths[0])
        for suf in (".nii.gz", ".nii", ".mha", ".mhd", ".nrrd", ".nhdr"):
            if base.endswith(suf):
                base = base[: -len(suf)]
                break
        self.name = os.path.basename(os.path.dirname(im_paths[0])) or base

    def load(self):
        if self.images is None:
            self.images = [read_image(p, dtype=np.float32) for p in self.im_paths]
            self.seg = read_image(self.seg_path)
            if not np.issubdtype(self.seg.data.dtype, np.integer):
                self.seg.data = np.rint(self.seg.data).astype(np.int32)
            fg = np.nonzero(self.seg.data > 0)
            self.fg_indices = np.stack(fg, axis=-1) if fg[0].size else None
            self.nbytes = (sum(v.data.nbytes for v in self.images)
                           + self.seg.data.size * 4)
        return self

    def stage(self, budget: list, device, boxes) -> tuple:
        """``(image tensors, seg tensor)`` on ``device`` for one crop: the
        part of each volume inside its box (``boxes``: the images', then the
        seg's ``SourceBox``). The whole case is uploaded once and kept
        there while it fits the remaining ``budget[0]`` bytes, and the boxes
        are views of it; else only the boxes are uploaded, for this crop
        (counted by the tracing counters ``train.stage_miss`` and
        ``train.stage_bytes``)."""
        if self.dev_images is None and budget[0] >= self.nbytes:
            self.dev_images = [torch.from_numpy(np.ascontiguousarray(v.data)).to(device)
                               for v in self.images]
            self.dev_seg = torch.from_numpy(self.seg.data.astype(np.int32)).to(device)
            budget[0] -= self.nbytes
        *im_boxes, seg_box = boxes
        if self.dev_images is not None:
            return ([t[b.slices] for t, b in zip(self.dev_images, im_boxes)],
                    self.dev_seg[seg_box.slices])
        images = [torch.from_numpy(np.ascontiguousarray(v.data[b.slices])).to(device)
                  for v, b in zip(self.images, im_boxes)]
        seg = torch.from_numpy(self.seg.data[seg_box.slices].astype(np.int32)).to(device)
        tracing.count("train.stage_miss")
        tracing.count("train.stage_bytes", sum(t.nbytes for t in images) + seg.nbytes)
        return images, seg


class SegmentationDataset:
    """Patch sampler with crops on ``device`` (default: the CPU)."""

    def __init__(self, imseg_list, num_classes, spacing, crop_size,
                 sampling_method=CENTER, random_translation=(0, 0, 0),
                 interpolation=LINEAR, crop_normalizers=None,
                 random_flip=False, seed=0, device_cache_gb=2.0,
                 random_rot90=False, random_intensity_scale=None,
                 random_intensity_shift=None, random_noise_std=0.0,
                 random_elastic_magnitude=0.0, random_elastic_grid=4,
                 random_elastic_prob=1.0, device=None):
        if isinstance(imseg_list, str):
            ims, segs = read_case_list(imseg_list)
        else:
            ims, segs = imseg_list
        self.cases = [_Case(i, s) for i, s in zip(ims, segs)]
        self.num_classes = int(num_classes)
        self.spacing = np.asarray(spacing, np.float64)
        self.crop_size = np.asarray(crop_size, np.int64)
        if sampling_method not in (GLOBAL, MASK, CENTER, MIX):
            raise ValueError(f"unknown sampling_method {sampling_method!r}")
        self.sampling_method = sampling_method
        self.random_translation = np.asarray(random_translation, np.float64)
        self.interpolation = interpolation
        self.crop_normalizers = crop_normalizers
        self.random_flip = bool(random_flip)
        self.random_rot90 = bool(random_rot90)
        if self.random_rot90 and crop_size[0] != crop_size[1]:
            raise ValueError(
                f"random_rot90 needs a square in-plane crop (x == y), got "
                f"crop_size {list(crop_size)}")
        self.random_intensity_scale = tuple(random_intensity_scale) \
            if random_intensity_scale else None
        self.random_intensity_shift = tuple(random_intensity_shift) \
            if random_intensity_shift else None
        self.random_noise_std = float(random_noise_std or 0.0)
        self.random_elastic_magnitude = float(random_elastic_magnitude or 0.0)
        self.random_elastic_grid = int(random_elastic_grid or 4)
        if self.random_elastic_magnitude > 0.0 and self.random_elastic_grid < 2:
            raise ValueError("random_elastic_grid must be >= 2")
        self.random_elastic_prob = float(random_elastic_prob
                                         if random_elastic_prob is not None
                                         else 1.0)
        self.device = torch.device(device) if device is not None \
            else torch.device("cpu")
        self._noise_gen = None
        if self.random_noise_std > 0.0:
            self._noise_gen = torch.Generator(device=self.device)
            self._noise_gen.manual_seed(int(seed) + 7)
        self.rng = np.random.default_rng(seed)
        self.num_modality = len(ims[0]) if ims else 1
        # remaining device bytes allowed for resident source volumes
        self._dev_budget = [int(float(device_cache_gb) * 1e9)]

    def __len__(self):
        return len(self.cases)

    # ---- center selection (host) -------------------------------------------
    def _select_center_world(self, case: _Case) -> np.ndarray:
        im = case.images[0]
        method = self.sampling_method
        if method == MIX:
            method = MASK if self.rng.random() < 0.5 else GLOBAL
        if method == CENTER:
            center = im.frame.voxel_center_world(im.size_xyz)
        elif method == MASK and case.fg_indices is not None:
            zyx = case.fg_indices[self.rng.integers(len(case.fg_indices))]
            center = case.seg.frame.index_to_world(zyx[::-1])
        else:  # GLOBAL (also MASK fallback on empty segmentation)
            idx = self.rng.uniform(0, im.size_xyz - 1)
            center = im.frame.index_to_world(idx)
        jitter = self.rng.uniform(-self.random_translation, self.random_translation)
        return np.asarray(center, np.float64) + jitter

    # ---- item assembly (device crops) --------------------------------------
    def __getitem__(self, idx: int):
        case = self.cases[idx].load()
        center = self._select_center_world(case)
        boxes = [source_box(v.frame, v.data.shape[:3], center, self.crop_size,
                            self.spacing) for v in case.images + [case.seg]]
        img_arrays, seg_array = case.stage(self._dev_budget, self.device, boxes)
        crops = []
        crop_frame = None
        for mi, im in enumerate(case.images):
            crop, crop_frame = crop_at_world_center(
                img_arrays[mi], im.frame, center, self.crop_size, self.spacing,
                interp=self.interpolation, box=boxes[mi])
            if self.crop_normalizers is not None and self.crop_normalizers[mi] is not None:
                crop = self.crop_normalizers[mi](crop)
            crops.append(crop)
        image = torch.stack(crops, dim=-1)  # [D,H,W,C]
        seg, _ = crop_at_world_center(
            seg_array, case.seg.frame, center,
            self.crop_size, self.spacing, interp=NN, box=boxes[-1])
        seg = torch.clamp(seg, 0, self.num_classes - 1)
        if self.random_flip:
            for ax in range(3):
                if self.rng.random() < 0.5:
                    image = torch.flip(image, (ax,))
                    seg = torch.flip(seg, (ax,))
        if self.random_rot90:
            k = int(self.rng.integers(4))
            if k:
                image = torch.rot90(image, k, dims=(1, 2))
                seg = torch.rot90(seg, k, dims=(1, 2))
        if self.random_elastic_magnitude > 0.0 \
                and self.rng.random() < self.random_elastic_prob:
            from segmentation3d_tpu_torch.ops.elastic import elastic_warp
            g = self.random_elastic_grid
            disp = self.rng.normal(
                0.0, self.random_elastic_magnitude, (g, g, g, 3))
            image, seg = elastic_warp(image, seg, torch.from_numpy(
                disp.astype(np.float32)))
        if self.random_intensity_scale is not None:
            lo, hi = self.random_intensity_scale
            image = image * float(np.float32(self.rng.uniform(lo, hi)))
        if self.random_intensity_shift is not None:
            lo, hi = self.random_intensity_shift
            image = image + float(np.float32(self.rng.uniform(lo, hi)))
        if self._noise_gen is not None:
            noise = torch.randn(image.shape, generator=self._noise_gen,
                                device=self.device, dtype=image.dtype)
            image = image + noise * float(np.float32(self.random_noise_std))
        return image.contiguous(), seg.contiguous(), crop_frame, case.name

    def batch(self, indices):
        """Assemble a batch -> (images [B,D,H,W,C], segs [B,D,H,W], frames, names)."""
        items = [self[i] for i in indices]
        images = torch.stack([it[0] for it in items])
        segs = torch.stack([it[1] for it in items])
        return images, segs, [it[2] for it in items], [it[3] for it in items]
