"""The case pool: CT-like volumes made on the card from the seed.

A phantom in Hounsfield units on a 0 mm-centred grid: air at -1000, an
elliptic body (fat ring at -100, soft tissue at 40), four spheres (organs
at 60, 150 and 200 HU, a lung-like one at -600), a spine at 700, and
Gaussian noise of 20 HU, truncated to int16 as a scanner's integers. Each
case moves the phantom by up to 10 mm on every axis. Its label marks the
two dense organs of the noiseless phantom (100 to 300 HU).

Volumes are written as uncompressed MetaImage (``.mha``) with an identity
direction and origin 0, and read back by :func:`read_nifti` in the mask's
format. Nothing here imports the program.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np
import torch

SPHERES = [(0, -20, 60, 45, 60), (30, 10, -70, 35, 150),
           (-40, 30, 0, 25, -600), (60, -30, -20, 20, 200)]


def phantom(shape_zyx, spacing_zyx, shift_zyx, gen, noise=20.0):
    """``(hu int16, label uint8)`` on the generator's device."""
    dev = gen.device
    z, y, x = ((torch.arange(n, device=dev, dtype=torch.float32) - n / 2) * d + o
               for n, d, o in zip(shape_zyx, spacing_zyx, shift_zyx))
    zz, yy, xx = z[:, None, None], y[None, :, None], x[None, None, :]
    body = (xx / 160.0) ** 2 + (yy / 110.0) ** 2
    img = torch.full(tuple(shape_zyx), -1000.0, device=dev)
    img = torch.where(body < 1.0, -100.0, img)
    img = torch.where(body < 0.6, 40.0, img)
    for cz, cy, cx, r, hu in SPHERES:
        img = torch.where((zz - cz) ** 2 + (yy - cy) ** 2 + (xx - cx) ** 2 < r * r,
                          float(hu), img)
    img = torch.where((yy - 70) ** 2 + xx ** 2 < 15 ** 2, 700.0, img)
    label = ((img >= 100) & (img < 300)).to(torch.uint8)
    if noise:
        n = torch.randn(img.shape, generator=gen, device=dev) * noise
        img = img + torch.trunc(n)
    return img.to(torch.int16), label


def make_pool(seed, spec, device):
    """The traffic's pool: ``[{"slices", "hu", "label", "spacing_zyx"}]``
    in the spec's order, every case from one generator on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sp = tuple(spec["spacing_xyz"][::-1])
    xy = spec["xy"]
    out = []
    for slices in spec["slices"]:
        shift = (torch.rand(3, generator=gen, device=device) * 20 - 10).tolist()
        hu, label = phantom((slices, xy, xy), sp, shift, gen)
        out.append({"slices": slices, "hu": hu, "label": label, "spacing_zyx": sp})
    return out


_MET = {np.dtype(np.int16): "MET_SHORT", np.dtype(np.uint8): "MET_UCHAR"}


def write_mha(path, data: np.ndarray, spacing_zyx):
    """Uncompressed inline MetaImage of a ``[Z, Y, X]`` array."""
    nz, ny, nx = data.shape
    sx, sy, sz = spacing_zyx[::-1]
    head = "\n".join([
        "ObjectType = Image", "NDims = 3", "BinaryData = True",
        "BinaryDataByteOrderMSB = False", "CompressedData = False",
        "TransformMatrix = 1 0 0 0 1 0 0 0 1", "Offset = 0 0 0",
        f"ElementSpacing = {sx!r} {sy!r} {sz!r}", f"DimSize = {nx} {ny} {nz}",
        f"ElementType = {_MET[data.dtype]}", "ElementDataFile = LOCAL", ""])
    with open(path, "wb") as f:
        f.write(head.encode("ascii"))
        f.write(memoryview(np.ascontiguousarray(data)).cast("B"))


_NIFTI_TYPES = {2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 256: np.int8}


def read_nifti(path):
    """``(data [Z, Y, X], spacing_zyx)`` of a NIfTI-1 file, gzipped or not."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    if struct.unpack("<i", raw[:4])[0] != 348:
        raise ValueError(f"{path}: not a little-endian NIfTI-1 file")
    dim = struct.unpack("<8h", raw[40:56])
    dtype = struct.unpack("<h", raw[70:72])[0]
    pixdim = struct.unpack("<8f", raw[76:108])
    offset = int(struct.unpack("<f", raw[108:112])[0])
    nx, ny, nz = dim[1:4]
    data = np.frombuffer(raw, _NIFTI_TYPES[dtype], nx * ny * nz, offset)
    return data.reshape(nz, ny, nx), tuple(float(v) for v in pixdim[3:0:-1])


def write_pool(pool, folder, with_labels=False):
    """Write every case (and its label) under ``folder``; returns the image
    paths and, with labels, the label paths."""
    os.makedirs(folder, exist_ok=True)
    images, labels = [], []
    for i, case in enumerate(pool):
        img = os.path.join(folder, f"case{i}_{case['slices']}.mha")
        write_mha(img, case["hu"].cpu().numpy(), case["spacing_zyx"])
        images.append(img)
        if with_labels:
            seg = os.path.join(folder, f"case{i}_{case['slices']}_seg.mha")
            write_mha(seg, case["label"].cpu().numpy(), case["spacing_zyx"])
            labels.append(seg)
    return (images, labels) if with_labels else images
