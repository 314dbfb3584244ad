"""Coarse-to-fine two-pass segmentation — the port of
``segmentation3d_tpu/core/coarse_to_fine.py``:

1. coarse pass: resample the whole volume to the coarse model's spacing
   (padded to ``shape_bucket``) and run one batch-1 forward over the whole
   grid;
2. ROI: the bounding box of the coarse foreground, reduced on the device to
   seven integers, plus a world-space margin;
3. fine pass: the sliding window only inside the ROI, on a grid at the fine
   model's spacing anchored at the ROI's centre (any direction matrix);
4. paste: the fine labels NN-resampled into the native frame (background
   elsewhere); probability maps read ``[1, 0, ...]`` outside the ROI.

Cases run on the pipelined loop of :mod:`.seg_infer` (read-ahead, write-
behind, per-case failure isolation, ``prepared=``). ``fine_model_dir`` may
be a list: a fine-fold ensemble averaged on the device, under the same
contract checks as ``segmentation``. ``quant="int8"`` quantizes the fine
models only; the coarse pass keeps full precision. ``tta`` mirror-averages
the fine pass. ``num_devices`` (or a list of devices) splits the fine
pass's patch batches over the shards; the coarse pass stays on the first
device. Both models, their forwards and inferers are kept across calls in
a session cache (``_C2F_SESSIONS``).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from segmentation3d_tpu_torch.core.infer_engine import SlidingWindowInferer, tta_axes
from segmentation3d_tpu_torch.core.seg_infer import (
    SegModel, _calib_paths, _case_loop, _check_ensemble_contract,
    _closed_on_error, _DeferredVolume, _model_dirs, _prepared_for, _StageClock,
    build_forward, build_forwards, checkpoint_identity, deferred_outputs,
    ensemble_forward, load_seg_model, prep_channels,
)
from segmentation3d_tpu_torch.io import Volume
from segmentation3d_tpu_torch.ops.geometry import Frame, resampled_frame
from segmentation3d_tpu_torch.ops.resample import NN, resample_exec, resample_plan
from segmentation3d_tpu_torch.parallel import shard_devices
from segmentation3d_tpu_torch.utils import tracing


def _post_prob_roi(prob, kind, coeffs, out_shape):
    """Resample fine-ROI class probabilities to the native grid with
    background = 1 outside the ROI: class 0 resamples as (p0 - 1) with fill
    0 and gets the 1 back, so out-of-ROI voxels read [1, 0, ...] (float16)."""
    shifted = prob.clone()
    shifted[..., 0] -= 1.0
    out = resample_exec(shifted, kind, coeffs, out_shape, out_dtype=torch.float16)
    out[..., 0] += 1.0
    return out


def _roi_bounds(mask):
    """Foreground bounding box of a label map ``[D, H, W]``, reduced on its
    device to seven int32s ``[found, zlo, zhi, ylo, yhi, xlo, xhi]``
    (inclusive), so the host reads 28 bytes instead of the mask."""
    fg = mask > 0

    def lohi(present):
        p = present.to(torch.uint8)
        return torch.argmax(p), p.shape[0] - 1 - torch.argmax(torch.flip(p, (0,)))

    zlo, zhi = lohi(fg.any(dim=2).any(dim=1))
    ylo, yhi = lohi(fg.any(dim=2).any(dim=0))
    xlo, xhi = lohi(fg.any(dim=1).any(dim=0))
    found = fg.any().to(torch.int64)
    return torch.stack([found, zlo, zhi, ylo, yhi, xlo, xhi]).to(torch.int32)


def _roi_world(lo_idx_xyz, hi_idx_xyz, frame: Frame, margin_mm: float):
    """World-space box of an index-space bbox + margin: min/max over the 8
    transformed corners (direction matrices permute/flip axes, so per-axis
    min/max must happen in world space)."""
    corners = []
    for ix in (lo_idx_xyz[0], hi_idx_xyz[0]):
        for iy in (lo_idx_xyz[1], hi_idx_xyz[1]):
            for iz in (lo_idx_xyz[2], hi_idx_xyz[2]):
                corners.append(frame.index_to_world([ix, iy, iz]))
    corners = np.asarray(corners)
    return corners.min(axis=0) - margin_mm, corners.max(axis=0) + margin_mm


def roi_from_mask(mask_zyx: np.ndarray, frame: Frame, margin_mm: float = 16.0):
    """World-space bounding box (lo_xyz, hi_xyz) of mask foreground + margin,
    for a mask already on the host. Returns None if the mask is empty."""
    nz = np.nonzero(mask_zyx > 0)
    if nz[0].size == 0:
        return None
    lo_idx = np.array([nz[2].min(), nz[1].min(), nz[0].min()], np.float64)
    hi_idx = np.array([nz[2].max(), nz[1].max(), nz[0].max()], np.float64)
    return _roi_world(lo_idx, hi_idx, frame, margin_mm)


def _fine_grid_for_roi(lo_xyz, hi_xyz, native: Volume, spacing, max_stride,
                       bucket: int = 1):
    """Fine-pass frame/size covering the ROI (clipped to the native volume),
    dims padded to x max(max_stride, bucket). Returns (frame, size_xyz,
    raw_size_xyz) where raw_size is the unpadded ROI extent (for adaptive
    normalizer statistics).

    The grid is centre-anchored — origin = box_center - D @ (spacing *
    (size-1)/2) — so it covers the world box for any direction matrix
    (a world-min-corner origin would point the grid away from the ROI under
    the diag(-1,-1,1) direction of every RAS-sform NIfTI). The native clip
    uses the full 8-corner box, and sizes come from the box extent projected
    onto each grid axis."""
    n = np.asarray(native.size_xyz, np.float64)
    corners = np.asarray([native.frame.index_to_world([ix, iy, iz])
                          for ix in (0.0, n[0] - 1.0)
                          for iy in (0.0, n[1] - 1.0)
                          for iz in (0.0, n[2] - 1.0)])
    lo = np.maximum(corners.min(axis=0), lo_xyz)
    hi = np.maximum(np.minimum(corners.max(axis=0), hi_xyz), lo)
    spacing = np.asarray(spacing, np.float64)
    D = np.asarray(native.frame.direction, np.float64)
    ext = np.abs(D).T @ (hi - lo)          # box extent along each grid axis
    raw = np.maximum(np.ceil(ext / spacing).astype(np.int64), 1)
    mult = max(int(max_stride), int(bucket or 0))
    size = (np.ceil(raw / mult) * mult).astype(np.int64)
    origin = (lo + hi) / 2.0 - D @ (spacing * (size - 1) / 2.0)
    return Frame(origin, spacing, D), size, raw


def segment_case_coarse_to_fine(
        coarse: SegModel, coarse_forward, fines, vols, coarse_inferers: dict,
        fine_inferers, patch_size_zyx, device, stride_zyx=None,
        margin_mm: float = 16.0, fill_value: float = 0.0,
        shape_bucket: int = 32, dev_data=None, save_prob=False,
        post_processing=None):
    """Enqueue the two passes of one case already read into ``vols``
    (``dev_data``: its uploads) on the current stream. ``coarse_inferers``
    caches one whole-grid inferer of ``coarse_forward`` per coarse grid
    shape; ``fines``/``fine_inferers``: the fine model(s) and one inferer
    each (more than one: an ensemble). Returns ``(mask, [(class, prob
    map)] or None, clock, roi)``: the outputs as ``_DeferredVolume``, the
    stage clock (``prep`` and ``forward`` of both passes, ``back``) and the
    world-space ROI ``(lo_xyz, hi_xyz)``, or None when the coarse pass found
    no foreground (the mask is then background, the probabilities
    [1, 0, ...])."""
    if len(vols) != coarse.in_channels:
        raise ValueError(f"model expects {coarse.in_channels} modalities, "
                         f"got {len(vols)}")
    native = vols[0]
    fine = fines[0]
    clock = _StageClock(device)

    # ---- pass 1: coarse whole-volume on its padded iso grid ---------------
    clock.mark("prep")
    pad_mult = max(coarse.max_stride, int(shape_bucket or 0))
    _, c_valid = resampled_frame(native.frame, native.size_xyz,
                                 coarse.spacing, 1)
    c_frame, c_size = resampled_frame(native.frame, native.size_xyz,
                                      coarse.spacing, pad_mult)
    cvol = prep_channels(coarse, vols, dev_data, c_frame, c_size, c_valid,
                         fill_value, device)
    clock.mark("forward")
    ckey = tuple(int(v) for v in cvol.shape[:3])
    if ckey not in coarse_inferers:
        coarse_inferers[ckey] = SlidingWindowInferer(
            coarse_forward, ckey, coarse.out_channels, batch_size=1,
            blend="constant")
    coarse_seg = coarse_inferers[ckey](cvol)
    del cvol
    # the ROI bbox reduced on the device; the host waits for 7 int32s
    b = _roi_bounds(coarse_seg).cpu().numpy()
    if not b[0]:
        clock.mark()
        shape = native.data.shape[:3]
        mask_vol = _DeferredVolume(native.frame,
                                   lambda: np.zeros(shape, np.uint8))
        prob_out = [(c, _DeferredVolume(
            native.frame, lambda c=c: np.full(shape, float(c == 0), np.float32)))
            for c in range(fine.out_channels)] if save_prob else None
        return mask_vol, prob_out, clock, None
    lo_idx = np.array([b[5], b[3], b[1]], np.float64)
    hi_idx = np.array([b[6], b[4], b[2]], np.float64)
    roi = _roi_world(lo_idx, hi_idx, c_frame, margin_mm)

    # ---- pass 2: fine sliding-window inside the ROI -----------------------
    clock.mark("prep")
    f_frame, f_size, f_raw = _fine_grid_for_roi(
        roi[0], roi[1], native, fine.spacing, fine.max_stride,
        bucket=shape_bucket)
    # patches must fit the ROI grid (the grid extends at the HIGH end only:
    # the origin computed by _fine_grid_for_roi is unchanged)
    f_size_orig = f_size.copy()
    f_size = np.maximum(f_size[::-1], np.asarray(patch_size_zyx))[::-1].copy()
    f_valid = np.minimum(f_raw, f_size)
    # the grid is centre-anchored: the bucket padding is split around the
    # ROI, so adaptive-normalizer statistics read the centred window
    f_off = np.maximum((f_size_orig - f_valid) // 2, 0)
    fvol = prep_channels(fine, vols, dev_data, f_frame, f_size,
                         np.concatenate([f_off, f_valid]), fill_value, device)
    clock.mark("forward")
    fine_seg, prob = ensemble_forward(fine_inferers, fvol, stride_zyx,
                                      return_prob=save_prob)
    del fvol

    # ---- paste the fine labels back into the native frame -----------------
    clock.mark("back")
    back_kind, back_coeffs, back_shape = resample_plan(
        f_frame, native.frame, native.size_xyz)
    m = resample_exec(fine_seg.to(torch.int32), back_kind, back_coeffs,
                      back_shape, interp=NN, fill=0.0).to(torch.uint8)
    # exact inside the ROI (where the fine model ran); outside, class 0
    # reads 1.0 and the other classes 0.0
    p = _post_prob_roi(prob, back_kind, back_coeffs, back_shape) \
        if save_prob else None
    ready = clock.mark()
    mask_vol, prob_out = deferred_outputs(m, p, native.frame, ready,
                                          post_processing, fine.out_channels)
    return mask_vol, prob_out, clock, roi


def _build_c2f_session(coarse_model_dir, fine_model_dirs, dtype, patch,
                       stride, batch_size, device, quant=None, act_clip=8.0,
                       calib_paths=None, tta=(), blend="gaussian",
                       coarse_checkpoint=None, fine_checkpoint=None):
    """Load both models, build their forwards and the fine inferer(s).

    ``device``: a device, or a shard list (the fine pass's shards; the
    coarse model and pass stay on its first device).
    ``quant="int8"`` quantizes the fine models (the fine pass dominates
    the two-pass time; ``calib_paths`` calibrates each of them as
    ``seg_infer --int8_calib`` does); the coarse pass keeps full precision.
    The patch rounds up to the fine model's stride (SIZE semantics); an
    equal stride (constant blend) follows the patch."""
    devices = list(device) if isinstance(device, (list, tuple)) else [device]
    device = devices[0]
    coarse = load_seg_model(coarse_model_dir, device, checkpoint=coarse_checkpoint)
    fines = [load_seg_model(d, device, checkpoint=fine_checkpoint)
             for d in fine_model_dirs]
    _check_ensemble_contract(fines, fine_model_dirs)
    ms = int(fines[0].max_stride)
    patch_eff = tuple(int(-(-p // ms) * ms) for p in patch)
    stride_eff = patch_eff if stride == patch else tuple(
        min(s, p) for s, p in zip(stride, patch_eff))
    # tta applies to the FINE pass only: the coarse pass exists to find the
    # ROI, where mirror averaging buys nothing the margin doesn't already
    fine_inferers = [SlidingWindowInferer(
        build_forwards(f, dtype, devices, quant=quant, act_clip=act_clip,
                       calib_paths=calib_paths),
        patch_eff, f.out_channels, batch_size=batch_size,
        blend=blend if stride_eff != patch_eff else "constant", tta=tta,
        devices=devices)
        for f in fines]
    return {"coarse": coarse, "coarse_forward": build_forward(coarse.net, dtype, device),
            "coarse_inferers": {}, "fines": fines, "fine_inferers": fine_inferers,
            "patch": patch_eff, "stride": stride_eff}


#: :func:`segmentation_coarse_to_fine`'s sessions (:func:`_build_c2f_session`
#: plus the coarse inferer of each coarse grid shape), keyed by both models'
#: checkpoint identities and every option that shapes them; at most two, the
#: oldest dropped first. Only the calling thread reads and writes it.
_C2F_SESSIONS: dict = {}
_C2F_SESSION_CAP = 2


@tracing.traced("infer.call")
def segmentation_coarse_to_fine(
        input_path, coarse_model_dir, fine_model_dir, output_dir,
        seg_name="seg.mha", partition_size=(96, 96, 96),
        partition_stride=None, batch_size=8, margin_mm=16.0,
        dtype=torch.float32, save_image=False, save_prob=False,
        post_processing=None, quant=None, act_clip=8.0, calib_image=None,
        tta=None, blend="gaussian", shape_bucket=32, coarse_checkpoint=None,
        fine_checkpoint=None, prepared=None, gpu_id=0, device=None,
        num_devices=1):
    """Segment all cases found at ``input_path`` in two passes into
    ``output_dir`` — ``segmentation``'s surface for the two-pass pipeline,
    with a checkpoint selector per model (``coarse_checkpoint``,
    ``fine_checkpoint``: 'latest' / 'best' / an epoch). ``partition_size``
    / ``partition_stride`` (xyz) tile the fine grid; ``margin_mm`` widens
    the ROI. ``save_prob`` maps are exact inside the ROI and [1, 0, ...]
    outside. Runs on ``cuda:<gpu_id>`` unless ``device`` says otherwise.
    ``num_devices`` (or ``device`` as a list, one entry per shard) shards
    the fine pass's patch batches as :func:`..core.seg_infer.segmentation`
    does; the coarse pass runs on the first device. Returns
    ``[(case_name, seconds, seconds_by_stage)]`` for this process's cases."""
    with _closed_on_error(prepared):
        if quant not in (None, "int8"):
            raise ValueError(f"quant {quant!r} is not one of None, 'int8'")
        calib_paths = _calib_paths(calib_image, quant)
        tta = tta_axes(tta)
        devs = shard_devices(num_devices, device, gpu_id)
        dev = devs[0]
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        patch = tuple(int(v) for v in np.asarray(partition_size)[::-1])
        stride = tuple(int(v) for v in np.asarray(partition_stride)[::-1]) \
            if partition_stride is not None else patch
        coarse_dir, fine_dirs = str(coarse_model_dir), _model_dirs(fine_model_dir)
        key = (checkpoint_identity(coarse_dir, coarse_checkpoint),
               tuple(checkpoint_identity(d, fine_checkpoint) for d in fine_dirs),
               dtype, patch, stride, int(batch_size), quant, float(act_clip),
               tuple(calib_paths) if calib_paths else None, tta, blend,
               tuple(devs))
        sess = _C2F_SESSIONS.get(key)
        if sess is None:
            sess = _build_c2f_session(
                coarse_dir, fine_dirs, dtype, patch, stride, batch_size, devs,
                quant=quant, act_clip=act_clip, calib_paths=calib_paths,
                tta=tta, blend=blend, coarse_checkpoint=coarse_checkpoint,
                fine_checkpoint=fine_checkpoint)
            while len(_C2F_SESSIONS) >= _C2F_SESSION_CAP:
                _C2F_SESSIONS.pop(next(iter(_C2F_SESSIONS)))
            _C2F_SESSIONS[key] = sess
        prepared = _prepared_for(prepared, input_path, dev)

    def run_case(case, vols, devs, case_dir):
        mask_vol, prob_out, case.clock, roi = segment_case_coarse_to_fine(
            sess["coarse"], sess["coarse_forward"], sess["fines"], vols,
            sess["coarse_inferers"], sess["fine_inferers"], sess["patch"], dev,
            stride_zyx=sess["stride"], margin_mm=margin_mm,
            shape_bucket=shape_bucket, dev_data=devs, save_prob=save_prob,
            post_processing=post_processing)
        case.note = f" (roi={'found' if roi is not None else 'empty'})"
        jobs = [(mask_vol, os.path.join(case_dir, seg_name))]
        if save_image:
            jobs.append((vols[0], os.path.join(case_dir, "org.mha")))
        jobs += [(p, os.path.join(case_dir, f"prob_{c}.mha"))
                 for c, p in prob_out or ()]
        return jobs

    return _case_loop(prepared, output_dir, run_case,
                      label="coarse-to-fine segmentation")
