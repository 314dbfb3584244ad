"""Inference entry — case discovery, model loading, per-case pipeline.

The port of ``segmentation3d_tpu/core/seg_infer.py``. Per case:

    read -> resample to model spacing (padded to the shape bucket) ->
    normalize -> sliding-window forward + blend (device) -> argmax ->
    NN-resample the mask back to the native frame -> optional
    connected-component cleanup -> write seg.mha / .nii.gz (+ optional prob
    maps, input copy)

Cases run one after another on one device. Under bf16 on a CUDA device the
forward is the BN-folded kernel forward (:mod:`..models.fused_vnet`), as the
JAX package's rule picks its fused forward for bf16 off the CPU; float32
runs the ``nn.Module`` forward with TF32 off.
"""
from __future__ import annotations

import os
import time
import traceback
from collections import Counter

import numpy as np
import torch

from segmentation3d_tpu_torch.core.infer_engine import SlidingWindowInferer
from segmentation3d_tpu_torch.io import Volume, read_image, write_image
from segmentation3d_tpu_torch.models import get_network_module
from segmentation3d_tpu_torch.ops.components import (
    pick_largest_connected_component, remove_small_connected_component,
)
from segmentation3d_tpu_torch.ops.geometry import (
    num_partition_by_size, resampled_frame,
)
from segmentation3d_tpu_torch.ops.resample import NN, resample_exec, resample_plan
from segmentation3d_tpu_torch.utils import model_io
from segmentation3d_tpu_torch.utils.device import no_tf32, resolve_device
from segmentation3d_tpu_torch.utils.normalizer import (
    AdaptiveNormalizer, normalizer_from_dict,
)

IMAGE_EXTS = (".nii.gz", ".nii", ".mha", ".mhd", ".nrrd", ".nhdr", ".hdr")

DISABLE, SIZE, NUM, SLAB = "DISABLE", "SIZE", "NUM", "SLAB"


def read_test_txt(path):
    """txt: line0 = case count, then per case one or more image paths."""
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    num_cases = int(lines[0])
    body = lines[1:]
    if num_cases <= 0 or len(body) % num_cases != 0:
        raise ValueError(
            f"{path}: {len(body)} path line(s) do not divide into the "
            f"declared {num_cases} case(s) — a silent mis-grouping would "
            "run inference on mismatched modality files")
    per_case = len(body) // num_cases
    return [body[i * per_case:(i + 1) * per_case] for i in range(num_cases)]


def read_test_csv(path):
    import csv as _csv
    cases = []
    with open(path, newline="") as f:
        reader = _csv.reader(f)
        next(reader)  # header
        for row in reader:
            row = [c.strip() for c in row if c.strip()]
            if row:
                cases.append(row)
    return cases


def find_cases(input_path):
    """Dispatch single image / .txt list / .csv / folder. A folder of volume
    files is one case per file; a folder containing ``.dcm`` slices is ONE
    DICOM-series case; otherwise subfolders that contain ``.dcm`` slices are
    each a series case."""
    if os.path.isdir(input_path):
        names = sorted(os.listdir(input_path))
        files = [os.path.join(input_path, f) for f in names
                 if f.lower().endswith(IMAGE_EXTS)]
        if files:
            return [[f] for f in files]
        if any(n.lower().endswith(".dcm") for n in names):
            return [[input_path]]  # the folder IS one DICOM series
        series = [os.path.join(input_path, n) for n in names
                  if os.path.isdir(os.path.join(input_path, n))
                  and any(m.lower().endswith(".dcm")
                          for m in os.listdir(os.path.join(input_path, n)))]
        return [[s] for s in series]
    if input_path.endswith(".txt"):
        return read_test_txt(input_path)
    if input_path.endswith(".csv"):
        return read_test_csv(input_path)
    return [[input_path]]


def _strip_ext(name):
    for suf in IMAGE_EXTS:
        if name.endswith(suf):
            return name[: -len(suf)]
    return name


def _case_names(cases):
    """One output-directory name per case, unique across the batch: the
    extension-stripped basename, disambiguated by the parent directory when
    several cases share a filename, and by a numeric suffix as a last
    resort."""
    base = [_strip_ext(os.path.basename(c[0])) for c in cases]
    names = list(base)
    dup = {n for n, k in Counter(names).items() if k > 1}
    if dup:
        names = [os.path.join(os.path.basename(os.path.dirname(c[0])), n)
                 if n in dup and os.path.basename(os.path.dirname(c[0]))
                 else n for n, c in zip(names, cases)]
    seen = Counter()
    out = []
    for n in names:
        seen[n] += 1
        out.append(n if seen[n] == 1 else f"{n}_{seen[n]}")
    return out


class SegModel:
    """A loaded, inference-ready model (net on its device + preprocessing
    spec)."""

    def __init__(self, net, spacing, max_stride, interpolation, normalizers,
                 in_channels, out_channels, net_name, epoch_idx):
        self.net = net
        self.spacing = spacing
        self.max_stride = max_stride
        self.interpolation = interpolation
        self.normalizers = normalizers
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.net_name = net_name
        self.epoch_idx = epoch_idx


def load_seg_model(model_dir: str, device, checkpoint=None) -> SegModel:
    """Restore everything from the self-describing ``params.pth`` of
    ``model_dir``'s checkpoint (``None``/``'latest'``, ``'best'`` or an
    epoch number) onto ``device``."""
    chk = model_io.resolve_checkpoint(model_dir, checkpoint)
    payload = model_io.load_checkpoint_payload(chk)
    if "_kernel_layouts" not in payload:
        raise NotImplementedError(
            f"{chk}: a checkpoint without _kernel_layouts (trained by the "
            "original PyTorch toolkit) needs the positional importer, which "
            "is not ported yet")
    net_mod = get_network_module(payload["net"])
    net_kwargs = dict(payload.get("net_kwargs") or {})
    net_kwargs.pop("dtype", None)
    net = net_mod.SegmentationNet(
        in_channels=int(payload["in_channels"]),
        out_channels=int(payload["out_channels"]), **net_kwargs)
    net.load_state_dict(payload["state_dict"], strict=True)
    net.to(device).eval()
    return SegModel(
        net=net,
        spacing=[float(s) for s in payload["spacing"]],
        max_stride=int(payload["max_stride"]),
        interpolation=payload.get("interpolation", "LINEAR"),
        normalizers=[normalizer_from_dict(d) for d in payload["crop_normalizers"]],
        in_channels=int(payload["in_channels"]),
        out_channels=int(payload["out_channels"]),
        net_name=payload["net"],
        epoch_idx=int(payload.get("epoch_idx", -1)),
    )


def module_forward(net, dtype):
    """``patches -> probabilities`` through the ``nn.Module``: float32 with
    TF32 off, or bf16 autocast (bf16 convs, float32 BatchNorm)."""
    dev_type = next(net.parameters()).device.type

    @torch.inference_mode()
    def forward(x):
        with no_tf32():
            if dtype == torch.bfloat16:
                with torch.autocast(dev_type, dtype=torch.bfloat16):
                    return net(x).to(torch.float32)
            return net(x.to(torch.float32))
    return forward


def prep_modality(vol: Volume, dst_frame, dst_size, interp, norm, valid_zyx,
                  fill_value, device):
    """One modality on the ``dst`` grid: upload as float32, resample with
    ``interp``, normalize with ``norm`` (adaptive statistics over the
    valid, unpadded region ``valid_zyx`` only)."""
    kind, coeffs, out_shape = resample_plan(vol.frame, dst_frame, dst_size)
    src = torch.from_numpy(np.asarray(vol.data, np.float32)).to(device)
    iso = resample_exec(src, kind, coeffs, out_shape, interp, fill_value,
                        out_dtype=torch.float32)
    if norm is None:
        return iso
    if isinstance(norm, AdaptiveNormalizer):
        vz, vy, vx = valid_zyx
        return norm(iso, stats_of=iso[:vz, :vy, :vx])
    return norm(iso)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def segmentation_one_case(model: SegModel, vols, inferer: SlidingWindowInferer,
                          device, stride_zyx=None, save_prob=False,
                          post_processing=None, shape_bucket: int = 64):
    """Segment one (possibly multi-modality) case already read into
    ``vols``. Returns ``(mask Volume, [(class, prob array)] or None,
    seconds by stage)``; stages are ``prep``, ``forward`` (forward + blend +
    argmax) and ``back`` (resample back to the native grid, host copy,
    post-processing)."""
    if len(vols) != model.in_channels:
        raise ValueError(f"model expects {model.in_channels} modalities, "
                         f"got {len(vols)}")
    native = vols[0]
    secs = {}
    t = time.perf_counter()
    pad_mult = max(model.max_stride, int(shape_bucket or 0))
    # modality 0 sets the iso grid; the others are resampled ONTO it so
    # modalities with shifted native frames stay registered in world space
    _, valid = resampled_frame(native.frame, native.size_xyz, model.spacing, 1)
    iso_frame, iso_size = resampled_frame(native.frame, native.size_xyz,
                                          model.spacing, pad_mult)
    valid_zyx = tuple(int(v) for v in np.asarray(valid)[::-1])
    # fill 0.0 outside the source: ITK's default pixel value
    vol = torch.stack([prep_modality(v, iso_frame, iso_size,
                                     model.interpolation, norm, valid_zyx,
                                     0.0, device)
                       for v, norm in zip(vols, model.normalizers)], dim=-1)
    _sync(device)
    secs["prep"] = time.perf_counter() - t

    t = time.perf_counter()
    seg_iso, prob = inferer(vol, stride_zyx=stride_zyx, return_prob=True)
    del vol
    _sync(device)
    secs["forward"] = time.perf_counter() - t

    t = time.perf_counter()
    back_kind, back_coeffs, back_shape = resample_plan(
        iso_frame, native.frame, native.size_xyz)
    m = resample_exec(seg_iso.to(torch.int32), back_kind, back_coeffs,
                      back_shape, interp=NN, fill=0.0)
    m = m.to(torch.uint8).cpu().numpy()
    if post_processing:
        kind = post_processing.get("type")
        if kind == "largest_cc":
            m = pick_largest_connected_component(m)
        elif kind == "remove_small_cc":
            m = remove_small_connected_component(
                m, int(post_processing.get("threshold", 64)))
    prob_out = None
    if save_prob:
        # all classes resampled in one pass; f16 as the JAX package reads it
        # back, f32 on disk
        p = resample_exec(prob, back_kind, back_coeffs, back_shape,
                          out_dtype=torch.float16).cpu().numpy()
        prob_out = [(c, p[..., c].astype(np.float32))
                    for c in range(model.out_channels)]
    secs["back"] = time.perf_counter() - t
    return Volume(m, native.frame), prob_out, secs


def _patch_and_stride(partition_type, partition_size, partition_stride,
                      iso_size, max_stride):
    """(patch, stride) zyx for a case whose padded iso grid is ``iso_size``
    (xyz)."""
    if partition_type == DISABLE:  # whole padded volume as a single patch
        patch = tuple(int(s) for s in iso_size[::-1])
        return patch, patch
    if partition_type == SIZE:
        # every volume is resampled + padded so it FITS its partition: a
        # case smaller than the requested box clamps the box to the volume
        psize = np.asarray(partition_size, np.int64)
        psize = (np.ceil(psize / max_stride) * max_stride).astype(np.int64)
        psize = np.minimum(psize, iso_size)
        pstride = np.asarray(partition_stride, np.int64) \
            if partition_stride is not None else psize
        pstride = np.minimum(pstride, psize)
        return (tuple(int(v) for v in psize[::-1]),
                tuple(int(v) for v in pstride[::-1]))
    if partition_type == SLAB:  # full-XY slabs overlapping only in z
        pz = int(np.asarray(partition_size).reshape(-1)[0]) \
            if partition_size is not None else 64
        pz = min(pz, int(iso_size[2]))
        sz = int(np.asarray(partition_stride).reshape(-1)[0]) \
            if partition_stride is not None else max(pz - 16, 1)
        return ((pz, int(iso_size[1]), int(iso_size[0])),
                (sz, int(iso_size[1]), int(iso_size[0])))
    if partition_type == NUM:  # a fixed NUMBER of boxes per axis
        psize, pstride = num_partition_by_size(iso_size, partition_size)
        psize = (np.ceil(psize / max_stride) * max_stride).astype(np.int64)
        psize = np.minimum(psize, iso_size)
        return (tuple(int(v) for v in psize[::-1]),
                tuple(int(v) for v in pstride[::-1]))
    raise NotImplementedError(f"partition_type {partition_type}")


def segmentation(input_path, model_dir, output_dir, seg_name="seg.mha",
                 gpu_id=0, save_image=False, save_prob=False,
                 partition_type=DISABLE, partition_size=None,
                 partition_stride=None, batch_size=8, blend="gaussian",
                 post_processing=None, dtype=torch.float32, fused=None,
                 shape_bucket=64, checkpoint=None, device=None):
    """Segment all cases found at ``input_path`` into ``output_dir``.

    Runs on ``cuda:<gpu_id>`` unless ``device`` says otherwise (``"cpu"``,
    or ``gpu_id=-1``); raises when no CUDA device is available and the CPU
    was not asked for. ``partition_type``: DISABLE (whole volume), SIZE
    (``partition_size``/``partition_stride`` boxes, xyz), SLAB, NUM.
    ``fused``: the BN-folded kernel forward (default: on for bfloat16 on a
    CUDA device). ``checkpoint``: ``None``/``'latest'``, ``'best'`` or an
    epoch number. Returns ``[(case_name, seconds, seconds_by_stage)]``.
    """
    dev = resolve_device(device, gpu_id)
    if not isinstance(model_dir, (str, os.PathLike)):
        raise NotImplementedError("ensembles (several model directories) "
                                  "are not ported yet")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
    if partition_type not in (DISABLE, SIZE, NUM, SLAB):
        raise NotImplementedError(f"partition_type {partition_type}")
    if fused is None:
        fused = dtype == torch.bfloat16 and dev.type == "cuda"
    model = load_seg_model(str(model_dir), dev, checkpoint=checkpoint)
    if fused:
        from segmentation3d_tpu_torch.models.fused_vnet import build_fused_forward
        forward = build_fused_forward(model.net, dtype=dtype)
    else:
        forward = module_forward(model.net, dtype)

    cases = find_cases(input_path)
    names = _case_names(cases)
    os.makedirs(output_dir, exist_ok=True)
    if not cases:
        print(f"warning: no cases found at {input_path}")
        return []
    inferers = {}
    results, failures = [], []
    pad_mult = max(model.max_stride, int(shape_bucket or 0))
    for image_paths, case_name in zip(cases, names):
        t0 = time.perf_counter()
        try:
            vols = [read_image(p) for p in image_paths]
        except Exception as e:  # one unreadable case must not abort the batch
            traceback.print_exc()
            print(f"ERROR: skipping {case_name}: {e}")
            failures.append((case_name, e))
            continue
        t_read = time.perf_counter() - t0
        try:
            v0 = vols[0]
            _, iso_size = resampled_frame(v0.frame, v0.size_xyz, model.spacing,
                                          pad_mult)
            patch, stride = _patch_and_stride(
                partition_type, partition_size, partition_stride, iso_size,
                model.max_stride)
            key = (patch, stride)
            if key not in inferers:
                inferers[key] = SlidingWindowInferer(
                    forward, patch, model.out_channels,
                    batch_size=1 if partition_type == SLAB else batch_size,
                    blend=blend if stride != patch else "constant")
            mask_vol, prob_out, secs = segmentation_one_case(
                model, vols, inferers[key], dev, stride_zyx=stride,
                save_prob=save_prob, post_processing=post_processing,
                shape_bucket=shape_bucket)
            t = time.perf_counter()
            case_dir = os.path.join(output_dir, case_name)
            write_image(mask_vol, os.path.join(case_dir, seg_name))
            if save_image:
                write_image(v0, os.path.join(case_dir, "org.mha"))
            for c, p in prob_out or ():
                write_image(Volume(p, v0.frame),
                            os.path.join(case_dir, f"prob_{c}.mha"))
            secs = {"read": t_read, **secs, "write": time.perf_counter() - t}
        except Exception as e:
            traceback.print_exc()
            print(f"ERROR: segmentation of {case_name} failed: {e}")
            failures.append((case_name, e))
            continue
        total = time.perf_counter() - t0
        print(f"segmentation of {case_name}: {total:.2f} s")
        results.append((case_name, total, secs))
    if failures and not results:
        raise failures[0][1]  # everything failed: not a per-case hiccup
    return results
