"""Inference entry — case discovery, model loading, the pipelined case loop.

The port of ``segmentation3d_tpu/core/seg_infer.py``. Per case:

    read -> resample to model spacing (padded to the shape bucket) ->
    normalize -> sliding-window forward + blend (device) -> argmax ->
    NN-resample the mask back to the native frame -> optional
    connected-component cleanup -> write seg.mha / .nii.gz (+ optional prob
    maps, input copy)

Cases run as a pipeline (:class:`_ReadAhead`, :class:`_WriteBehind`). While
the calling thread prepares and forwards case N on the device, a decode
thread reads case N+1 and an upload thread copies its voxels, in their
stored dtype and through pinned memory, to the device on a CUDA stream of
its own; a materialize thread copies case N-1's mask back on another stream
and runs the connected-component cleanup, and a write thread writes it.
Every queue holds two cases. The calling thread's work is timed with CUDA
events, so it never waits for the device to time a stage.

Under bf16 on a CUDA device the forward is the BN-folded kernel forward
(:mod:`..models.fused_vnet`), as the JAX package's rule picks its fused
forward for bf16 off the CPU; float32 runs the ``nn.Module`` forward with
TF32 off. ``quant="int8"`` runs the int8 forward (:mod:`..models.quant_vnet`)
on whichever device was resolved: the kernels on a CUDA device, their plain
versions on the CPU. A bottleneck net (``vbnet``) has neither folded form:
it runs the ``nn.Module`` forward, and ``quant`` raises, as in the JAX
package. ``model_dir`` may name several models: an ensemble whose class
probabilities are averaged on the device before the argmax.

Left out on purpose: the JAX package's bit-packing of volumes and masks for
its slow host link, its session cache and its multi-host case slicing.
"""
from __future__ import annotations

import os
import queue
import threading
import time
import traceback
from collections import Counter

import numpy as np
import torch

from segmentation3d_tpu_torch.core.infer_engine import SlidingWindowInferer, tta_axes
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

#: stored voxel types that cross to the device as they are; any other
#: crosses as float32 (one cast on the host)
_UPLOAD_TYPES = {np.dtype(np.uint8): torch.uint8, np.dtype(np.int8): torch.int8,
                 np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32,
                 np.dtype(np.float32): torch.float32}


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


def build_forward(model: SegModel, dtype, device, fused=None, quant=None,
                  act_clip=8.0, calib_paths=None):
    """``patches -> probabilities`` for one model: the int8 forward
    (``quant``, calibrated on ``calib_paths`` when given), else the
    BN-folded kernel forward (``fused``; default: bf16 on a CUDA device),
    else the ``nn.Module`` forward. A bottleneck net has no folded form:
    it runs the module forward, and ``quant`` raises the JAX package's
    error."""
    if model.net.bottleneck:
        if quant is not None:
            raise ValueError(
                f"quant={quant!r} requires the packed-domain forward, which "
                "this architecture does not support")
        return module_forward(model.net, dtype)
    if quant is not None:
        from segmentation3d_tpu_torch.models.quant_vnet import build_int8_forward
        calib = _calibrate_for_model(model, calib_paths, dtype, device) \
            if calib_paths is not None else None
        return build_int8_forward(model.net, act_clip=act_clip, calib=calib,
                                  dtype=dtype)
    if fused is None:
        fused = dtype == torch.bfloat16 and device.type == "cuda"
    if fused:
        from segmentation3d_tpu_torch.models.fused_vnet import build_fused_forward
        return build_fused_forward(model.net, dtype=dtype)
    return module_forward(model.net, dtype)


def _upload(data, device):
    """A volume's voxels on ``device``, in their stored dtype where torch has
    it (CT: int16), else float32. On a CUDA device they go through pinned
    memory by an asynchronous copy on the calling thread's current stream."""
    a = np.asarray(data)
    dt = a.dtype.newbyteorder("=")
    if dt not in _UPLOAD_TYPES:
        dt = np.dtype(np.float32)
    if device.type != "cuda":
        return torch.from_numpy(np.require(a, dt, ("C", "W")))
    pinned = torch.empty(a.shape, dtype=_UPLOAD_TYPES[dt], pin_memory=True)
    np.copyto(pinned.numpy(), a, casting="unsafe")
    return pinned.to(device, non_blocking=True)


def prep_modality(vol: Volume, dst_frame, dst_size, interp, norm, valid_zyx,
                  fill_value, device, src=None):
    """One modality on the ``dst`` grid: its voxels on the device (``src``,
    the read-ahead's upload, else uploaded here), resampled with ``interp``
    in float32, normalized with ``norm``. An adaptive normalizer takes its
    statistics over the valid, unpadded region only: ``valid_zyx`` is
    ``(vz, vy, vx)`` from the low corner or ``(oz, oy, ox, vz, vy, vx)``
    with an offset (the centre-anchored coarse-to-fine grid)."""
    kind, coeffs, out_shape = resample_plan(vol.frame, dst_frame, dst_size)
    if src is None:
        src = _upload(vol.data, device)
    iso = resample_exec(src, kind, coeffs, out_shape, interp, fill_value,
                        out_dtype=torch.float32)
    if norm is None:
        return iso
    if isinstance(norm, AdaptiveNormalizer):
        oz, oy, ox = tuple(valid_zyx[:-3]) or (0, 0, 0)
        vz, vy, vx = valid_zyx[-3:]
        return norm(iso, stats_of=iso[oz:oz + vz, oy:oy + vy, ox:ox + vx])
    return norm(iso)


def prep_channels(model: SegModel, vols, dev_data, dst_frame, dst_size,
                  valid_xyz, fill_value, device):
    """A model's input channels on the ``dst`` grid, ``[D, H, W, C]``
    (:func:`prep_modality` per modality; ``dev_data``: the modalities'
    uploads or None). ``valid_xyz``: ``(vx, vy, vz)`` sizes or
    ``(ox, oy, oz, vx, vy, vz)`` with an offset."""
    vv = tuple(int(t) for t in np.asarray(valid_xyz).reshape(-1))
    valid_zyx = vv[2::-1] if len(vv) == 3 else vv[2::-1] + vv[:2:-1]
    return torch.stack([
        prep_modality(v, dst_frame, dst_size, model.interpolation, norm,
                      valid_zyx, fill_value, device,
                      src=dev_data[i] if dev_data is not None else None)
        for i, (v, norm) in enumerate(zip(vols, model.normalizers))], dim=-1)


def _calibrate_for_model(model: SegModel, image_paths, dtype, device,
                         cap: int = 192):
    """Per-site activation maxima for the int8 forward, measured on one
    calibration image (one path per modality) prepared as for inference:
    resampled to the model's spacing and padded to ``max_stride``,
    normalized (over the whole resampled volume), then centre-cropped to
    at most ``cap`` voxels per axis to bound the one full-precision
    measuring forward."""
    from segmentation3d_tpu_torch.models.quant_vnet import calibrate_int8
    if len(image_paths) != model.in_channels:
        raise ValueError(
            f"calibration needs {model.in_channels} modality image(s), "
            f"got {len(image_paths)}")
    chans = []
    for p, norm in zip(image_paths, model.normalizers):
        vol = read_image(p)
        frame, size = resampled_frame(vol.frame, vol.size_xyz, model.spacing,
                                      model.max_stride)
        kind, coeffs, out_shape = resample_plan(vol.frame, frame, size)
        src = torch.from_numpy(np.asarray(vol.data, np.float32)).to(device)
        iso = resample_exec(src, kind, coeffs, out_shape, model.interpolation,
                            0.0, out_dtype=torch.float32)
        chans.append(norm(iso) if norm is not None else iso)
    x = torch.stack(chans, dim=-1)
    crop = []
    for n in x.shape[:3]:
        t = min(n, cap)
        crop.append(slice((n - t) // 2, (n - t) // 2 + t))
    return calibrate_int8(model.net, [x[tuple(crop)][None]], dtype=dtype)


def _check_ensemble_contract(models, model_dirs):
    """Ensemble members must agree on everything that shapes preprocessing
    and the output space — the iso volume is built once and shared, and
    class probabilities are averaged elementwise."""
    def contract(m):
        return (tuple(float(s) for s in m.spacing), m.interpolation,
                int(m.max_stride), int(m.in_channels), int(m.out_channels),
                tuple(tuple(sorted(n.to_dict().items())) if n is not None
                      else None for n in m.normalizers))
    base = contract(models[0])
    for m, d in zip(models[1:], model_dirs[1:]):
        if contract(m) != base:
            raise ValueError(
                f"ensemble member {d!r} disagrees with {model_dirs[0]!r} on "
                "the preprocessing contract (spacing / interpolation / "
                "max_stride / channel counts / normalizers) — ensembles "
                "average probabilities on one shared iso grid, so members "
                "must be folds of the same configuration")


def ensemble_forward(inferers, vol, stride_zyx=None):
    """``(mask, prob)`` of ``inferers`` (one per ensemble member) on
    ``vol``: the mean of the members' class probabilities and its argmax
    (one member: its own)."""
    if len(inferers) == 1:
        return inferers[0](vol, stride_zyx=stride_zyx, return_prob=True)
    prob = inferers[0](vol, stride_zyx=stride_zyx, return_prob=True)[1]
    for inf in inferers[1:]:
        prob = prob + inf(vol, stride_zyx=stride_zyx, return_prob=True)[1]
    prob = prob / float(len(inferers))
    return torch.argmax(prob, dim=-1).to(torch.uint8), prob


class _StageClock:
    """Seconds by stage of one case's work on the calling thread. On a CUDA
    device each mark records an event on the current stream, so the stages
    are spans of the device's timeline and the thread does not wait for
    the device; they are read once the last event has completed. On the
    CPU, the host clock."""

    def __init__(self, device):
        self._device = device
        self._cuda = device.type == "cuda"
        self._marks = []  # (stage that starts here or None, event or time)

    def mark(self, stage=None):
        """End the running stage and start ``stage`` (None: none). Returns
        the mark: on a CUDA device an event that the work before it
        completes."""
        if self._cuda:
            stamp = torch.cuda.Event(enable_timing=True)
            stamp.record(torch.cuda.current_stream(self._device))
        else:
            stamp = time.perf_counter()
        self._marks.append((stage, stamp))
        return stamp

    def seconds(self) -> dict:
        if self._cuda and self._marks:
            self._marks[-1][1].synchronize()
        secs = {}
        for (stage, a), (_, b) in zip(self._marks, self._marks[1:]):
            if stage is not None:
                d = a.elapsed_time(b) / 1e3 if self._cuda else b - a
                secs[stage] = secs.get(stage, 0.0) + d
        return secs


def _to_host(t, ready):
    """``t`` as a numpy array. A CUDA tensor is copied into pinned memory on
    the calling thread's current stream after the event ``ready``."""
    if t.device.type != "cuda":
        return t.numpy()
    stream = torch.cuda.current_stream(t.device)
    stream.wait_event(ready)
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    stream.synchronize()
    return host.numpy()


class _HostCopy:
    """A device tensor's host copy, made on first use and then shared."""

    def __init__(self, tensor, ready):
        self._tensor, self._ready, self._host = tensor, ready, None

    def __call__(self):
        if self._host is None:
            self._host = _to_host(self._tensor, self._ready)
            self._tensor = None  # the device copy may go
        return self._host


class _DeferredVolume:
    """A result volume whose voxels are produced by ``thunk`` — a device to
    host copy (:class:`_HostCopy`) and any host finishing, such as the
    connected-component cleanup — called by ``materialize()`` in the
    write-behind's materialize thread."""

    def __init__(self, frame, thunk):
        self.frame = frame
        self._thunk = thunk

    def materialize(self) -> Volume:
        return Volume(self._thunk(), self.frame)


def _post_process(m, post_processing):
    if post_processing:
        kind = post_processing.get("type")
        if kind == "largest_cc":
            m = pick_largest_connected_component(m)
        elif kind == "remove_small_cc":
            m = remove_small_connected_component(
                m, int(post_processing.get("threshold", 64)))
    return m


def deferred_outputs(mask, prob, frame, ready, post_processing, num_classes):
    """``(mask, [(class, prob map)] or None)`` as :class:`_DeferredVolume`
    over the native-grid device tensors ``mask`` (uint8) and ``prob``
    (float16 ``[D,H,W,NC]`` or None), ready after the event ``ready``; the
    probabilities cross once and are written as float32."""
    host_mask = _HostCopy(mask, ready)
    mask_vol = _DeferredVolume(frame,
                               lambda: _post_process(host_mask(), post_processing))
    if prob is None:
        return mask_vol, None
    host_prob = _HostCopy(prob, ready)
    return mask_vol, [
        (c, _DeferredVolume(frame, lambda c=c: host_prob()[..., c].astype(np.float32)))
        for c in range(num_classes)]


def segmentation_one_case(model: SegModel, vols, inferers, device,
                          stride_zyx=None, save_prob=False,
                          post_processing=None, shape_bucket: int = 64,
                          dev_data=None):
    """Enqueue one (possibly multi-modality) case already read into
    ``vols`` (``dev_data``: its uploads) on the current stream:
    ``inferers`` holds one :class:`SlidingWindowInferer` per ensemble
    member. Returns ``(mask, [(class, prob map)] or None, clock)``, the
    outputs as :class:`_DeferredVolume` and ``clock`` the
    :class:`_StageClock` of the stages ``prep``, ``forward`` (forward +
    blend + argmax) and ``back`` (resample back to the native grid)."""
    if len(vols) != model.in_channels:
        raise ValueError(f"model expects {model.in_channels} modalities, "
                         f"got {len(vols)}")
    native = vols[0]
    clock = _StageClock(device)
    clock.mark("prep")
    pad_mult = max(model.max_stride, int(shape_bucket or 0))
    # modality 0 sets the iso grid; the others are resampled ONTO it so
    # modalities with shifted native frames stay registered in world space
    _, valid = resampled_frame(native.frame, native.size_xyz, model.spacing, 1)
    iso_frame, iso_size = resampled_frame(native.frame, native.size_xyz,
                                          model.spacing, pad_mult)
    # fill 0.0 outside the source: ITK's default pixel value
    vol = prep_channels(model, vols, dev_data, iso_frame, iso_size, valid,
                        0.0, device)
    clock.mark("forward")
    seg_iso, prob = ensemble_forward(inferers, vol, stride_zyx)
    del vol
    clock.mark("back")
    back_kind, back_coeffs, back_shape = resample_plan(
        iso_frame, native.frame, native.size_xyz)
    m = resample_exec(seg_iso.to(torch.int32), back_kind, back_coeffs,
                      back_shape, interp=NN, fill=0.0).to(torch.uint8)
    # all classes resampled in one pass; f16 as the JAX package reads it back
    p = resample_exec(prob, back_kind, back_coeffs, back_shape,
                      out_dtype=torch.float16) if save_prob else None
    ready = clock.mark()
    mask_vol, prob_out = deferred_outputs(m, p, native.frame, ready,
                                          post_processing, model.out_channels)
    return mask_vol, prob_out, clock


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


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

class _ReadAhead:
    """Background case reader as a two-stage pipeline on separate threads:

      decode thread:  file read + gunzip + parse (``read_image``)
      upload thread:  the voxels, in their stored dtype, into pinned memory
                      and onto the device by an asynchronous copy on a CUDA
                      stream of its own, waited for before hand-over

    so the decode of case N+2, the upload of case N+1 and the device work of
    case N overlap. Iterating yields ``(paths, vols, devs, read_error,
    (start, seconds))``: ``devs`` the modalities' device tensors (the
    consumer marks them used by its own stream, :func:`_adopt`), ``start``
    the ``perf_counter`` at which the case's read began, ``seconds`` the
    time of both stages. An unreadable case yields its error; one failed
    case must not abort the batch, so the caller decides. An error that
    ends a thread is raised to the consumer instead of ending the cases."""

    def __init__(self, cases, device, depth=2):
        self.device = device
        self.q = queue.Queue(maxsize=max(1, depth))
        self._uq = queue.Queue(maxsize=1)
        self._stop = threading.Event()
        self.error = None
        self._dt = threading.Thread(target=self._decode, args=(list(cases),),
                                    daemon=True)
        self._ut = threading.Thread(target=self._upload, daemon=True)
        self._dt.start()
        self._ut.start()

    def _decode(self, cases):
        try:
            for image_paths in cases:
                if self._stop.is_set():
                    break
                t0 = time.perf_counter()
                try:
                    vols, err = [read_image(p) for p in image_paths], None
                except Exception as e:  # surfaced at consumption time
                    vols, err = None, e
                self._uq.put((image_paths, vols, err, t0, time.perf_counter() - t0))
        except BaseException as e:  # raised again by __next__
            self.error = e
            raise
        finally:
            self._uq.put(None)

    def _upload(self):
        cuda = self.device.type == "cuda"
        try:
            stream = torch.cuda.Stream(self.device) if cuda else None
            with torch.cuda.stream(stream):
                while (item := self._uq.get()) is not None:
                    image_paths, vols, err, t0, secs = item
                    devs = None
                    if err is None and not self._stop.is_set():
                        t = time.perf_counter()
                        try:
                            devs = [_upload(v.data, self.device) for v in vols]
                            if cuda:
                                stream.synchronize()
                        except Exception as e:  # surfaced at consumption time
                            err = e
                        secs += time.perf_counter() - t
                    self.q.put((image_paths, vols, devs, err, (t0, secs)))
        except BaseException as e:  # raised again by __next__
            self.error = e
            raise
        finally:
            self.q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            if self.error is not None:
                raise self.error
            raise StopIteration
        return item

    def close(self):
        """Stop reading and let both threads end: a loop that was aborted,
        or a thread that died, leaves cases in the queues."""
        self._stop.set()
        for thread, q in ((self._ut, self.q), (self._dt, self._uq)):
            while thread.is_alive():
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass


def _adopt(tensors):
    """Mark tensors uploaded on another stream as used by this thread's
    current stream: without it the caching allocator could hand their
    memory to the next upload while this stream still reads them."""
    for t in tensors:
        if t.is_cuda:
            t.record_stream(torch.cuda.current_stream(t.device))


class _Case:
    """One case on its way through the pipeline: where its read began, its
    seconds by stage (filled in by the threads that run them) and when its
    write ended."""

    def __init__(self, name, start, read_seconds, label):
        self.name, self.start, self.label = name, start, label
        self.secs = {"read": read_seconds}
        self.clock = None
        self.note = ""
        self.end = None


class _WriteBehind:
    """Background result writer as a two-stage pipeline (the mirror of
    :class:`_ReadAhead`):

      materialize thread:  device->host copy of the mask and prob maps on a
                           CUDA stream of its own, after the event that
                           ends the case's device work, + CC cleanup
      write thread:        file writes (gzip for .nii.gz)

    so case N's write overlaps case N+1's readback, which overlaps case
    N+2's device work. Each case's stage seconds are completed here: its
    device stages from its clock, the materialize time added to ``back``,
    and ``write``. A failure of either stage is collected with the case's
    name and returned by :meth:`close`."""

    def __init__(self, device, depth=2):
        self.device = device
        self.q = queue.Queue(maxsize=max(1, depth))
        self._wq = queue.Queue(maxsize=max(1, depth))
        self.failures = []
        self._mt = threading.Thread(target=self._materialize, daemon=True)
        self._wt = threading.Thread(target=self._write, daemon=True)
        self._mt.start()
        self._wt.start()

    def _materialize(self):
        try:
            stream = torch.cuda.Stream(self.device) \
                if self.device.type == "cuda" else None
            with torch.cuda.stream(stream):
                while (item := self.q.get()) is not None:
                    case, jobs = item
                    try:
                        case.secs.update(case.clock.seconds())
                        t = time.perf_counter()
                        jobs = [(v.materialize() if isinstance(v, _DeferredVolume)
                                 else v, path) for v, path in jobs]
                        case.secs["back"] = (case.secs.get("back", 0.0)
                                             + time.perf_counter() - t)
                    except Exception as e:  # collected, surfaced at close
                        traceback.print_exc()
                        self.failures.append((case.name, e))
                        continue
                    self._wq.put((case, jobs))
        finally:
            self._wq.put(None)

    def _write(self):
        while (item := self._wq.get()) is not None:
            case, jobs = item
            t = time.perf_counter()
            try:
                for vol, path in jobs:
                    write_image(vol, path)
                case.end = time.perf_counter()
                case.secs["write"] = case.end - t
                print(f"{case.label} of {case.name}: "
                      f"{case.end - case.start:.2f} s{case.note}")
            except Exception as e:  # collected, surfaced at close
                traceback.print_exc()
                self.failures.append((case.name, e))

    def submit(self, case, jobs):
        self.q.put((case, jobs))

    def close(self):
        """Drain both stages; returns the ``(case name, error)`` failures."""
        self.q.put(None)
        self._mt.join()
        self._wt.join()
        return self.failures


class PreparedInput:
    """An input whose case discovery and two-stage read-ahead (decode +
    stored-dtype upload to ``device``) already started — built by
    :func:`prepare_cases`, consumed by :func:`segmentation` /
    ``segmentation_coarse_to_fine`` via ``prepared=``, so a caller can
    overlap the next input's reads with the current one's device work."""

    def __init__(self, input_path, device):
        self.input_path = input_path
        self.device = device
        self.cases = find_cases(input_path)
        self.names = _case_names(self.cases)
        self.reader = _ReadAhead(self.cases, device) if self.cases else None


def prepare_cases(input_path, device=None, gpu_id=0) -> PreparedInput:
    """Start reading ``input_path``'s cases onto the device (resolved as
    :func:`segmentation` resolves it) in the background; pass the result as
    ``segmentation(..., prepared=...)``."""
    return PreparedInput(input_path, resolve_device(device, gpu_id))


def _prepared_for(prepared, input_path, device):
    if prepared is None:
        return PreparedInput(input_path, device)
    if prepared.input_path != input_path:
        raise ValueError(f"prepared input is for {prepared.input_path!r}, "
                         f"not {input_path!r}")
    if prepared.device != device:
        raise ValueError(f"prepared input is read onto {prepared.device}, "
                         f"not {device}")
    return prepared


def _case_loop(prepared, output_dir, run_case, label="segmentation"):
    """Run every case of ``prepared`` through the pipeline:
    ``run_case(case, vols, devs, case_dir)`` enqueues a read case's device
    work on the calling thread, sets ``case.clock`` and returns its write
    jobs ``[(volume or _DeferredVolume, path)]``. An unreadable or failing
    case is reported and skipped; the writer is drained even when the loop
    is aborted, and a case whose write failed leaves the results. Returns
    ``[(case_name, seconds, seconds_by_stage)]``: ``seconds`` from the
    start of the case's read to the end of its write; stages ``read``
    (read + upload), ``prep``, ``forward``, ``back`` (resample back + host
    copy + post-processing), ``write``."""
    os.makedirs(output_dir, exist_ok=True)
    if not prepared.cases:
        print(f"warning: no cases found at {prepared.input_path}")
        return []
    cases, failures = [], []
    writer = _WriteBehind(prepared.device)
    try:
        for (paths, vols, devs, read_err, (start, read_s)), name in zip(
                prepared.reader, prepared.names):
            if read_err is not None:
                print(f"ERROR: skipping {name}: {read_err}")
                failures.append((name, read_err))
                continue
            case = _Case(name, start, read_s, label)
            try:
                _adopt(devs)
                jobs = run_case(case, vols, devs, os.path.join(output_dir, name))
            except Exception as e:  # one bad case must not abort the batch
                traceback.print_exc()
                print(f"ERROR: {label} of {name} failed: {e}")
                failures.append((name, e))
                continue
            writer.submit(case, jobs)
            cases.append(case)
    finally:
        # the writer is drained even when the loop is aborted (KeyboardInterrupt,
        # a config-level error): cases already handed to it must not silently
        # lose their pending writes
        prepared.reader.close()
        for name, e in writer.close():
            print(f"ERROR: writing results of {name} failed: {e}")
            failures.append((name, e))
    failed = {name for name, _ in failures}
    results = [(c.name, c.end - c.start, c.secs) for c in cases
               if c.name not in failed]
    if failures and not results:
        raise failures[0][1]  # everything failed: not a per-case hiccup
    return results


def _model_dirs(model_dir):
    dirs = [str(model_dir)] if isinstance(model_dir, (str, os.PathLike)) \
        else [str(d) for d in model_dir]
    if not dirs:
        raise ValueError("model_dir must name at least one model directory")
    return dirs


def _calib_paths(calib_image, quant):
    if calib_image is None:
        return None
    if quant is None:
        raise ValueError("calib_image only applies with quant")
    return list(calib_image) if isinstance(calib_image, (list, tuple)) \
        else [calib_image]


def segmentation(input_path, model_dir, output_dir, seg_name="seg.mha",
                 gpu_id=0, save_image=False, save_prob=False,
                 partition_type=DISABLE, partition_size=None,
                 partition_stride=None, batch_size=8, blend="gaussian",
                 post_processing=None, dtype=torch.float32, fused=None,
                 shape_bucket=64, checkpoint=None, device=None, quant=None,
                 act_clip=8.0, calib_image=None, tta=None, prepared=None):
    """Segment all cases found at ``input_path`` into ``output_dir``.

    Runs on ``cuda:<gpu_id>`` unless ``device`` says otherwise (``"cpu"``,
    or ``gpu_id=-1``); raises when no CUDA device is available and the CPU
    was not asked for. ``model_dir``: a model directory, or a list of them
    (an ensemble: members must share the preprocessing contract; their
    class probabilities are averaged on the device before the argmax).
    ``partition_type``: DISABLE (whole volume), SIZE
    (``partition_size``/``partition_stride`` boxes, xyz), SLAB, NUM.
    ``fused``: the BN-folded kernel forward (default: on for bfloat16 on a
    CUDA device). ``checkpoint``: ``None``/``'latest'``, ``'best'`` or an
    epoch number. ``quant="int8"``: the int8 forward, with static
    activation scales ``act_clip / 127``, or measured on ``calib_image``
    (a path, or one path per modality) with one full-precision forward per
    member. ``tta``: test-time mirror averaging over the named axes of the
    resampled volume ('x', 'zy', 'all'; 2^n forwards per patch batch).
    ``prepared``: a :func:`prepare_cases` of ``input_path`` whose reads
    already started. Returns ``[(case_name, seconds, seconds_by_stage)]``.
    """
    if quant not in (None, "int8"):
        raise ValueError(f"quant {quant!r} is not one of None, 'int8'")
    calib_paths = _calib_paths(calib_image, quant)
    if quant is not None and fused is False:
        raise ValueError("quant requires the fused forward (fused=False given)")
    tta = tta_axes(tta)  # normalized early: bad axis names fail every case
    dev = resolve_device(device, gpu_id)
    model_dirs = _model_dirs(model_dir)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
    if partition_type not in (DISABLE, SIZE, NUM, SLAB):
        raise NotImplementedError(f"partition_type {partition_type}")
    models = [load_seg_model(d, dev, checkpoint=checkpoint) for d in model_dirs]
    _check_ensemble_contract(models, model_dirs)
    forwards = [build_forward(m, dtype, dev, fused, quant, act_clip, calib_paths)
                for m in models]
    model = models[0]
    pad_mult = max(model.max_stride, int(shape_bucket or 0))
    inferers = {}

    def run_case(case, vols, devs, case_dir):
        v0 = vols[0]
        _, iso_size = resampled_frame(v0.frame, v0.size_xyz, model.spacing,
                                      pad_mult)
        patch, stride = _patch_and_stride(
            partition_type, partition_size, partition_stride, iso_size,
            model.max_stride)
        key = (patch, stride)
        if key not in inferers:
            inferers[key] = [SlidingWindowInferer(
                f, patch, model.out_channels,
                batch_size=1 if partition_type == SLAB else batch_size,
                blend=blend if stride != patch else "constant", tta=tta)
                for f in forwards]
        mask_vol, prob_out, case.clock = segmentation_one_case(
            model, vols, inferers[key], dev, stride_zyx=stride,
            save_prob=save_prob, post_processing=post_processing,
            shape_bucket=shape_bucket, dev_data=devs)
        jobs = [(mask_vol, os.path.join(case_dir, seg_name))]
        if save_image:
            jobs.append((v0, os.path.join(case_dir, "org.mha")))
        jobs += [(p, os.path.join(case_dir, f"prob_{c}.mha"))
                 for c, p in prob_out or ()]
        return jobs

    return _case_loop(_prepared_for(prepared, input_path, dev), output_dir,
                      run_case)
