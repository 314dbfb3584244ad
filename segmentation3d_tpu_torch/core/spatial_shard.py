"""Spatially sharded inference of one volume: z-slabs with halo exchange.

The port of ``segmentation3d_tpu/core/spatial_shard.py``. One volume's z
axis is split over the shards (a list of devices, one entry per shard, that
may repeat a device), so no shard holds the whole volume's accumulators:

1. the depth ``D`` is padded with zeros to ``Dl * n`` planes, ``Dl =
   ceil(max(D, pz) / n)``, and shard ``d`` holds planes ``[d*Dl, (d+1)*Dl)``;
2. each shard pulls the input halo, the next ``pz`` planes, from the shards
   after it, one hop per shard (zeros past the last one);
3. each shard runs the full-XY slab patches whose z-start it owns (the
   start's shard, clamped to ``n - 1``) through the net, blending into a
   ``[Dl + pz]``-plane accumulator pair with a z-only weight profile;
4. the accumulators' overflow (the ``pz`` planes past the shard's range)
   travels hop by hop to the shards after it, each folding the first
   ``Dl`` planes it receives into its own head;
5. each shard divides and takes the argmax of its planes; the uint8 mask
   planes (and the probabilities, when asked for) are gathered on the
   first device.

A hop is a copy between devices ordered by their streams
(:mod:`..parallel.devices`); a hop past the last shard gives zeros, as a
missing link of the JAX package's ``ppermute`` ring does.
"""
from __future__ import annotations

import numpy as np
import torch

from segmentation3d_tpu_torch.parallel.devices import ShardStreams
from segmentation3d_tpu_torch.utils.device import no_tf32, resolve_device


def z_weight_profile(pz: int, kind: str = "gaussian", sigma_scale: float = 0.125):
    """Blend weight along z only ([pz,1,1,1]): slab patches span full XY, so
    an XY profile is a common factor of every patch covering a voxel and
    cancels in the prob/wsum division — z-only is the cheap equivalent of
    the 3-D map in ``infer_engine.make_weight_map``."""
    if kind == "constant":
        return np.ones((pz, 1, 1, 1), np.float32)
    zz = np.linspace(-1.0, 1.0, pz)
    w = np.exp(-0.5 * (zz / (2.0 * sigma_scale)) ** 2)
    w = np.maximum(w, w.max() * 1e-3).astype(np.float32)
    return w[:, None, None, None]


def _z_starts(D: int, pz: int, sz: int) -> np.ndarray:
    """Slab z-start positions covering [0, D) (last box clamped flush)."""
    if D <= pz:
        return np.zeros((1,), np.int64)
    starts = list(range(0, D - pz + 1, sz))
    if starts[-1] != D - pz:
        starts.append(D - pz)
    return np.asarray(starts, np.int64)


class SpatialShardedInferer:
    """Sliding-window inference over ONE z-sharded volume (slab patches).

    ``forward``: ``patches [1,pz,H,W,Cin] -> probabilities [1,pz,H,W,NC]``,
    or a dict of such forwards by device. ``devices``: one entry per shard
    (a device may repeat; shards on one device run one after another on
    its stream). A call takes the volume on the first shard's device."""

    def __init__(self, forward, slab_z: int, num_classes: int, devices,
                 stride_z: int | None = None, blend: str = "gaussian"):
        self.forward = forward
        self.pz = int(slab_z)
        self.sz = int(stride_z) if stride_z else max(self.pz - 16, 1)
        self.num_classes = int(num_classes)
        self.devices = [resolve_device(d) for d in devices]
        if blend not in ("gaussian", "constant"):
            raise ValueError(f"unknown blend {blend!r}")
        self.weight = z_weight_profile(self.pz, blend)
        self._streams = ShardStreams(self.devices)

    def _forward_on(self, device):
        return self.forward[device] if isinstance(self.forward, dict) else self.forward

    def _blend(self, ext, zs, device):
        """One shard's slabs at local z-starts ``zs`` of its extended volume
        ``ext [Dl+pz,H,W,C]`` blended into ``(prob, wsum)`` over its
        ``Dl + pz`` planes."""
        pz = self.pz
        forward = self._forward_on(device)
        weight = torch.from_numpy(self.weight).to(device)
        prob = torch.zeros(tuple(ext.shape[:3]) + (self.num_classes,),
                           dtype=torch.float32, device=device)
        wsum = torch.zeros(tuple(ext.shape[:3]) + (1,), dtype=torch.float32,
                           device=device)
        for z0 in zs:
            p = forward(ext[z0:z0 + pz][None])[0].to(torch.float32)
            prob[z0:z0 + pz] += p * weight
            wsum[z0:z0 + pz] += weight
        return prob, wsum

    @torch.inference_mode()
    def __call__(self, vol, stride_zyx=None, return_prob=False):
        """vol: [D,H,W,C] (or [D,H,W]) on the first shard's device. Returns
        mask [D,H,W] uint8 (+ prob [D,H,W,NC] float32 if requested), on
        that device.

        ``stride_zyx``: optional (sz, -, -); only the z stride is used
        (slab patches span full XY), so the call takes the same arguments
        as :class:`~.infer_engine.SlidingWindowInferer`'s."""
        sz = int(np.asarray(stride_zyx).reshape(-1)[0]) if stride_zyx is not None \
            else self.sz
        if vol.dim() == 3:
            vol = vol[..., None]
        devs, pz, streams = self.devices, self.pz, self._streams
        if vol.device != devs[0]:
            raise ValueError(f"the volume is on {vol.device}, not on the first "
                             f"shard's device {devs[0]}")
        D, n = int(vol.shape[0]), len(devs)
        Dl = -(-max(D, pz) // n)
        if Dl * n != D:
            vol = torch.cat([vol, vol.new_zeros((Dl * n - D,) + tuple(vol.shape[1:]))])

        # global slab starts, each owned by the shard holding its z-start
        starts = _z_starts(Dl * n, pz, sz)
        owner = np.minimum(starts // Dl, n - 1)
        zs = [(starts[owner == d] - d * Dl).tolist() for d in range(n)]

        streams.start()
        own = [streams.scatter(vol[d * Dl:(d + 1) * Dl], dev)
               for d, dev in enumerate(devs)]
        ext = []
        for d, dev in enumerate(devs):
            # the input halo: the next shards' leading planes, one hop each
            parts, need, h = [], pz, 1
            while need > 0:
                take = min(Dl, need)
                if d + h < n:
                    parts.append(streams.move(own[d + h][:take], dev))
                else:
                    with streams.on(dev):
                        parts.append(own[d].new_zeros((take,) + tuple(own[d].shape[1:])))
                need -= take
                h += 1
            with streams.on(dev):
                ext.append(torch.cat([own[d]] + parts))
        del own

        def work(dev):
            return [(d, self._blend(ext[d], zs[d], dev))
                    for d in range(n) if devs[d] == dev]
        with no_tf32():  # set once: the shards' threads share the flags
            acc = dict(sum(streams.run(work).values(), []))
        del ext

        # the overflow, planes [Dl, Dl+pz), hop by hop to the shards after
        # it, each folding the first Dl planes it receives into its head
        heads = [(acc[d][0][:Dl], acc[d][1][:Dl]) for d in range(n)]
        rem = [(acc[d][0][Dl:], acc[d][1][Dl:]) for d in range(n)]
        left = pz
        while left > 0:
            take = min(Dl, left)
            nxt = [None] * n
            for d in range(1, n):
                if rem[d - 1] is None:
                    continue  # zeros from past the first shard
                rp, rw = (streams.move(t, devs[d]) for t in rem[d - 1])
                with streams.on(devs[d]):
                    heads[d][0][:take] += rp[:take]
                    heads[d][1][:take] += rw[:take]
                nxt[d] = (rp[take:], rw[take:])
            rem, left = nxt, left - take

        masks, probs = [], []
        for d, dev in enumerate(devs):
            with streams.on(dev):
                p = heads[d][0] / torch.clamp_min(heads[d][1], 1e-8)
                m = torch.argmax(p, dim=-1).to(torch.uint8)
            masks.append(streams.gather(m))
            if return_prob:
                probs.append(streams.gather(p))
        mask = torch.cat(masks)[:D]
        if return_prob:
            return mask, torch.cat(probs)[:D]
        return mask
