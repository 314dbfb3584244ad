"""Sliding-window inference: batched patches, blending on the device.

The port of ``segmentation3d_tpu/core/infer_engine.py``
(``make_weight_map``, ``tta_axes``, ``tta_flip_combos``,
``SlidingWindowInferer`` with its test-time flips and on-device ``dice``):
patches are gathered from the device-resident normalized volume and
forwarded in batches; per-class probabilities are pasted into float32
``prob``/``wsum`` accumulators with a per-patch weight map (Gaussian or
constant), divided by ``max(wsum, 1e-8)`` and reduced to a uint8 mask with
``argmax``, all on the device. The last batch may be shorter than the
others.

Several shards (``devices=``, the JAX engine's ``mesh=``): the box batches
split into contiguous runs, one per shard; each shard pastes its run into
accumulators of its own on its device (the volume is copied once to each
distinct device), and the first device adds them up in shard order, the
counterpart of the JAX engine's one ``psum``. Sharding one volume in z
lives in :mod:`.spatial_shard`.

A forward that says it can be captured (its attribute ``capturable``, which
:func:`..models.fused_vnet.build_fused_forward` sets on a CUDA device) runs
from CUDA graphs on a CUDA device: one graph per device and batch shape
holds the batch's weighted probabilities (the forward, its flips, the
multiply by the weight map); each batch is copied into the graph's static
input and replays it (:class:`_DeviceGraphs`). The same ops run in the
same order as eagerly, so the outputs are the same, and the host enqueues
one replay instead of the forward's ops. Every other forward, and every
CPU forward, runs eagerly. Counters (while tracing): ``infer.graph_captures``,
``infer.graph_replays`` (batches replayed) and ``infer.graph_eager``
(batches run eagerly).
"""
from __future__ import annotations

import collections
import threading

import numpy as np
import torch

from segmentation3d_tpu_torch.ops import thin_conv
from segmentation3d_tpu_torch.ops.geometry import partition_boxes
from segmentation3d_tpu_torch.parallel.devices import ShardStreams
from segmentation3d_tpu_torch.utils import tracing
from segmentation3d_tpu_torch.utils.device import no_tf32, resolve_device


def make_weight_map(patch_size_zyx, kind: str = "gaussian", sigma_scale: float = 0.125):
    """Per-patch blending weights [pd,ph,pw,1]; 'constant' = plain averaging."""
    pd, ph, pw = patch_size_zyx
    if kind == "constant":
        return np.ones((pd, ph, pw, 1), np.float32)
    zz = np.linspace(-1.0, 1.0, pd)
    yy = np.linspace(-1.0, 1.0, ph)
    xx = np.linspace(-1.0, 1.0, pw)
    sig = 2.0 * sigma_scale
    gz = np.exp(-0.5 * (zz / sig) ** 2)
    gy = np.exp(-0.5 * (yy / sig) ** 2)
    gx = np.exp(-0.5 * (xx / sig) ** 2)
    w = gz[:, None, None] * gy[None, :, None] * gx[None, None, :]
    w = np.maximum(w, w.max() * 1e-3).astype(np.float32)
    return w[..., None]


def tta_axes(tta):
    """Normalize a TTA spec — None/''/'none', 'all', an 'xz'/'x,z' string,
    or an iterable of axis names — to a canonical ('z','y','x')-ordered
    tuple of unique axis names."""
    if tta is None:
        return ()
    if isinstance(tta, str):
        t = tta.strip().lower().replace(",", "")
        if t in ("", "none"):
            return ()
        tta = "zyx" if t == "all" else t
    axes = {str(a).strip().lower() for a in tta}
    bad = axes - {"z", "y", "x"}
    if bad:
        raise ValueError(f"tta axes must be from z/y/x (or 'all'), "
                         f"got {sorted(bad)}")
    return tuple(a for a in ("z", "y", "x") if a in axes)


def tta_flip_combos(axes):
    """All non-empty flip combinations of the named patch axes, as tuples of
    tensor dims of a [B, z, y, x, C] patch batch (z=1, y=2, x=3)."""
    dim = {"z": 1, "y": 2, "x": 3}
    dims = [dim[a] for a in tta_axes(axes)]
    combos = []
    for bits in range(1, 1 << len(dims)):
        combos.append(tuple(d for i, d in enumerate(dims) if bits >> i & 1))
    return tuple(combos)


#: torch.cuda.graphs allows one capture at a time in a process; the
#: shards' threads of a sharded call may each reach their first capture
_CAPTURE = threading.Lock()


def _capture(fn, inp, pool, stream):
    """``(graph, out, launches)``: ``out = fn(inp)`` captured into a CUDA
    graph on ``stream`` in ``pool``, and the kernel launches the capture
    recorded (:func:`..ops.thin_conv.recorded_launches`). ``fn`` has run
    eagerly before (the shape's first batch), so its lazy state is made.

    The capture mode is ``"thread_local"``: the read-ahead's and the
    writer's threads keep copying and synchronizing on their own streams
    meanwhile, which ``"global"`` would count against the capture."""
    graph = torch.cuda.CUDAGraph()
    here = torch.cuda.current_stream(inp.device)
    stream.wait_stream(here)
    with _CAPTURE, torch.cuda.device(inp.device), torch.cuda.stream(stream):
        before = thin_conv.recorded_launches()
        graph.capture_begin(pool, capture_error_mode="thread_local")
        try:
            out = fn(inp)
        finally:
            graph.capture_end()
        launches = thin_conv.recorded_launches() - before
    here.wait_stream(stream)
    return graph, out, launches


#: one batch shape's graph: its static input and output, and the kernel
#: launches each replay makes
_Graph = collections.namedtuple("_Graph", "inp graph out launches")


class _DeviceGraphs:
    """An inferer's batch graphs on one CUDA device, one per batch shape.

    A shape's first batch runs eagerly: it makes the forward's lazy state
    (the kernels' builds and plans, cuDNN's and cuBLAS's handles) outside
    any graph, and a forward that sees one batch of a shape (validation's
    whole-volume patch, a one-slab case) is never captured. Its second
    batch captures the graph (:func:`_capture`), its static input the
    stack of the batch's slices; it and every later batch of the shape are
    copied into that input and replay the graph, which adds the launches
    its capture recorded to ``thin_conv3d.launches``. Each batch runs once,
    eagerly or replayed, so a case launches what it launched without graphs.

    The capture stream is one of the high-priority streams, which no other
    code of the port takes: torch hands out its pooled streams round-robin,
    and a read-ahead's or writer's stream that came out as the capture
    stream would have its copies captured into the graph.

    The graphs share one memory pool and one capture stream. Sharing is
    safe because each graph's output stays referenced here, so no other
    capture is handed its memory, and what the graphs do share, their
    intermediates, is dead once a replay ends: every replay and the paste
    that reads its output run in stream order, on the stream that was
    current at the replay, and a replay on another stream than the last
    one first waits for that stream."""

    def __init__(self, device):
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device, priority=-1)
        self.graphs = {}  # batch shape -> _Graph; None after its first batch
        self.last = None  # the stream of the last replay

    def run(self, fn, slices):
        """``fn`` of the stacked ``slices`` from the shape's graph, or None
        where the batch has to run eagerly (the shape's first)."""
        key = (len(slices), slices[0].dtype) + tuple(slices[0].shape)
        if key not in self.graphs:
            self.graphs[key] = None
            return None
        here = torch.cuda.current_stream(slices[0].device)
        if self.last is not None and self.last != here:
            here.wait_stream(self.last)
        self.last = here
        g = self.graphs[key]
        if g is None:
            inp = torch.stack(slices)
            g = self.graphs[key] = _Graph(inp, *_capture(fn, inp, self.pool, self.stream))
            tracing.count("infer.graph_captures")
        else:
            torch.stack(slices, out=g.inp)
        g.graph.replay()
        thin_conv.thin_conv3d.launches += g.launches
        tracing.count("infer.graph_replays")
        return g.out


class SlidingWindowInferer:
    """Whole-volume inference: partition -> batched forward -> blend.

    ``forward(patches [B,pd,ph,pw,Cin]) -> probabilities [B,pd,ph,pw,NC]``,
    or a dict of such forwards by device: the one of the device a batch is
    on runs it. ``tta``: test-time mirror augmentation over the named patch
    axes (see :func:`tta_axes`): each batch's probabilities are averaged
    over every flip combination, 2^n forwards per batch. ``devices``: one
    entry per shard (a device may repeat); with more than one, the box
    batches are split over the shards and ``forward`` must be a dict that
    holds each of their devices.
    """

    def __init__(self, forward, patch_size_zyx, num_classes, batch_size=8,
                 blend="gaussian", tta=None, devices=None):
        self.forward = forward
        self.patch_size = tuple(int(v) for v in patch_size_zyx)
        self.num_classes = int(num_classes)
        self.batch_size = int(batch_size)
        if blend not in ("gaussian", "constant"):
            raise ValueError(f"unknown blend {blend!r}")
        self.blend = blend
        self.tta = tta_axes(tta)
        self._tta_flips = tta_flip_combos(self.tta)
        # as the JAX engine drops a mesh of one device
        self.devices = [resolve_device(d) for d in devices] \
            if devices is not None and len(devices) > 1 else None
        self._streams = ShardStreams(self.devices) if self.devices else None
        self._weights = {}  # device -> the weight map there
        self._graphs = {}  # CUDA device -> _DeviceGraphs

    def boxes_for(self, vol_shape_zyx, stride_zyx=None):
        """Patch start coordinates (N,3) zyx for a volume shape."""
        pd, ph, pw = self.patch_size
        if stride_zyx is None:
            stride_zyx = self.patch_size
        size_xyz = np.asarray(vol_shape_zyx, np.int64)[::-1]
        boxes_xyz = partition_boxes(size_xyz, (pw, ph, pd), np.asarray(stride_zyx)[::-1])
        return np.ascontiguousarray(boxes_xyz[:, ::-1])  # -> zyx starts

    def _forward_on(self, device):
        return self.forward[device] if isinstance(self.forward, dict) else self.forward

    def _forward(self, forward, patches):
        """The batch's probabilities in float32, averaged over the flips."""
        out = forward(patches).to(torch.float32)
        for dims in self._tta_flips:
            out = out + torch.flip(
                forward(torch.flip(patches, dims)).to(torch.float32), dims)
        if self._tta_flips:
            out = out / np.float32(1 + len(self._tta_flips))
        return out

    def _weight(self, device):
        """The weight map [pd,ph,pw,1] on ``device``, built once."""
        w = self._weights.get(device)
        if w is None:
            w = self._weights[device] = torch.from_numpy(
                make_weight_map(self.patch_size, self.blend)).to(device)
        return w

    def _graphs_on(self, forward, device):
        """The :class:`_DeviceGraphs` of ``device``, or None where batches
        run eagerly (a CPU device, a forward not marked ``capturable``)."""
        if device.type != "cuda" or not getattr(forward, "capturable", False):
            return None
        graphs = self._graphs.get(device)
        if graphs is None:
            graphs = self._graphs[device] = _DeviceGraphs(device)
        return graphs

    def _accumulators(self, vol):
        """Zero ``prob [D,H,W,NC]`` and ``wsum [D,H,W,1]`` on ``vol``'s device."""
        shape = tuple(vol.shape[:3])
        return (torch.zeros(shape + (self.num_classes,), dtype=torch.float32,
                            device=vol.device),
                torch.zeros(shape + (1,), dtype=torch.float32, device=vol.device))

    def _paste(self, vol, batches, prob, wsum):
        """Forward each batch of box starts and paste its weighted
        probabilities into ``prob``/``wsum``, on ``vol``'s device."""
        pd, ph, pw = self.patch_size
        forward = self._forward_on(vol.device)
        weight = self._weight(vol.device)
        graphs = self._graphs_on(forward, vol.device)

        def weighted(patches):
            return self._forward(forward, patches) * weight
        for bxs in batches:
            starts = bxs.tolist()
            slices = [vol[z:z + pd, y:y + ph, x:x + pw] for z, y, x in starts]
            out = graphs.run(weighted, slices) if graphs is not None else None
            if out is None:
                tracing.count("infer.graph_eager")
                out = weighted(torch.stack(slices))
            for (z, y, x), p in zip(starts, out):
                prob[z:z + pd, y:y + ph, x:x + pw] += p
                wsum[z:z + pd, y:y + ph, x:x + pw] += weight

    def _sharded(self, vol, batches):
        """``(prob, wsum)`` on ``vol``'s device, the sum in shard order of
        each shard's accumulators over its contiguous run of batches (the
        JAX engine's split of the padded batch axis over ``P("data")``,
        without its all-padding batches)."""
        n, streams = len(self.devices), self._streams
        per = -(-len(batches) // n)
        runs = {}
        for k, dev in enumerate(self.devices):
            if k * per < len(batches):
                runs.setdefault(dev, []).append((k, batches[k * per:(k + 1) * per]))
        streams.start()
        local = {dev: streams.scatter(vol, dev) for dev in runs}

        def work(dev):
            out = []
            for k, run in runs.get(dev, ()):
                prob, wsum = self._accumulators(local[dev])
                self._paste(local[dev], run, prob, wsum)
                out.append((k, prob, wsum))
            return out
        shards = sorted(sum(streams.run(work).values(), []), key=lambda s: s[0])
        prob = wsum = None
        for _, p, w in shards:  # into the first shard's pair, in shard order
            p, w = streams.gather(p), streams.gather(w)
            if prob is None:
                prob, wsum = p, w
            else:
                prob += p
                wsum += w
        return prob, wsum

    @torch.inference_mode()
    def dice(self, vol, gt, valid_zyx, stride_zyx=None):
        """Per-class Dice of the sliding-window prediction against ``gt``
        (the iso-grid label volume [D,H,W], any dtype with integer values)
        over the unpadded region ``valid_zyx`` (vz, vy, vx), reduced on
        ``vol``'s device: only ``2 * (num_classes - 1)`` numbers are read
        back. Returns a numpy float32 [NC-1] array of
        ``2 * inter / max(|gt==c| + |pred==c|, 1)``. Single-device."""
        if self.devices is not None:
            raise NotImplementedError("on-device dice is single-chip "
                                      "(validation never builds a mesh)")
        seg = self(vol, stride_zyx=stride_zyx)
        vz, vy, vx = (int(v) for v in valid_zyx)
        seg = seg[:vz, :vy, :vx].to(torch.int32)
        gt = torch.as_tensor(gt).to(seg.device)[:vz, :vy, :vx].to(torch.int32)
        rows = []
        for c in range(1, self.num_classes):
            pc, gc = seg == c, gt == c
            rows.append(torch.stack([(pc & gc).sum(), pc.sum() + gc.sum()]))
        sums = torch.stack(rows).cpu().numpy().astype(np.float32)
        return 2.0 * sums[:, 0] / np.maximum(sums[:, 1], 1.0)

    @torch.inference_mode()
    def __call__(self, vol, stride_zyx=None, return_prob=False):
        """Sliding-window inference over ``vol [D,H,W,Cin]`` (or [D,H,W]) on
        its device (with shards: the first shard's). Returns ``mask [D,H,W]
        uint8`` (+ ``prob [D,H,W,NC]`` float32 when ``return_prob``)."""
        if vol.dim() == 3:
            vol = vol[..., None]
        if self.devices is not None and vol.device != self.devices[0]:
            raise ValueError(f"the volume is on {vol.device}, not on the first "
                             f"shard's device {self.devices[0]}")
        boxes = self.boxes_for(tuple(vol.shape[:3]), stride_zyx)
        batches = [boxes[i:i + self.batch_size]
                   for i in range(0, len(boxes), self.batch_size)]
        if self.devices is None:
            prob, wsum = self._accumulators(vol)
            self._paste(vol, batches, prob, wsum)
        else:
            with no_tf32():  # set once: the shards' threads share the flags
                prob, wsum = self._sharded(vol, batches)
        prob = prob / torch.clamp_min(wsum, 1e-8)
        mask = torch.argmax(prob, dim=-1).to(torch.uint8)
        if return_prob:
            return mask, prob
        return mask
