"""The devices one process drives, and what stands in for the mesh's
collectives between them.

The counterpart of ``segmentation3d_tpu/parallel/mesh.py:make_mesh``. One
process drives its local devices from a list with one entry per shard
(:func:`shard_devices`). An entry may repeat, so one device can hold
several shards, as the JAX package's tests hold several virtual CPU devices
on one host. A list of one device runs the single-device code, as the JAX
package drops a mesh of size 1.

:class:`ShardStreams` gives each distinct CUDA device of a shard list a
stream and, for each call, a thread of its own. A shard's tensors live on
its device's stream; the caller's work stays on the caller's current
stream of the first device. A ``ppermute`` hop becomes a copy between two
devices ordered by the streams of both (:func:`hop`), and a ``psum`` a sum
in shard order on the first device, so results do not depend on timing.
No collective library is involved.
"""
from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor

import torch

from segmentation3d_tpu_torch.utils.device import resolve_device


def shard_devices(num_devices=1, device=None, gpu_id=0) -> list:
    """The devices of a run, one entry per shard.

    ``device`` may be a list (repeats allowed): it is the shard list, and
    ``num_devices`` must then be left at 1. Otherwise the first device is
    resolved as :func:`..utils.device.resolve_device` resolves it, and
    ``num_devices`` (the JAX package's meaning: greater than 1, or -1 for
    all; 0 and 1 mean one) adds to it:

    - on CUDA, ``min(num_devices, visible - first)`` distinct GPUs starting
      at the first (``-1``: every visible GPU from the first on), clamped
      as ``make_mesh`` clamps to the devices there are;
    - on the CPU, ``num_devices`` CPU shards; the CPU counts as one device
      for ``-1``, as the JAX package's default CPU backend does.
    """
    if isinstance(device, (list, tuple)):
        if num_devices not in (None, 1):
            raise ValueError("pass num_devices or a list of devices, not both")
        devs = [resolve_device(d) for d in device]
        if not devs:
            raise ValueError("the device list is empty")
        if len({d.type for d in devs}) > 1:
            raise ValueError(f"shards must all be CUDA devices or all the CPU, "
                             f"got {[str(d) for d in devs]}")
        return devs
    first = resolve_device(device, gpu_id)
    n = int(num_devices) if num_devices is not None else 1
    if 0 <= n <= 1:
        return [first]
    if first.type == "cuda":
        avail = torch.cuda.device_count() - first.index
        n = avail if n < 0 else min(n, avail)
        return [torch.device("cuda", first.index + i) for i in range(n)]
    return [first] * (1 if n < 0 else n)


def distinct(devices) -> list:
    """The distinct devices of a shard list, in order of first appearance."""
    return list(dict.fromkeys(devices))


def hop(t, device, src_stream=None, dst_stream=None):
    """``t`` on ``device``: the counterpart of one ``ppermute`` hop. The copy
    starts after the work on ``src_stream`` (the stream that made ``t``;
    None: the caller's current stream of ``t``'s device) and the work
    after it on ``dst_stream`` (None: the caller's current stream of
    ``device``) waits for it. A tensor already there is returned as is."""
    if t.device == device:
        return t
    with _on(src_stream), _on(dst_stream):
        return t.to(device, non_blocking=True)


def _on(stream):
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


class ShardStreams:
    """One stream per distinct device of a CUDA shard list (none on the
    CPU), kept for the life of the engine that owns it.

    A call goes: :meth:`start` orders every shard stream after the caller's
    work so far; :meth:`scatter` and :meth:`move` place tensors on shards;
    :meth:`run` runs each device's shards, on a thread and its stream per
    device on CUDA, one after another in the calling thread on the CPU;
    :meth:`gather` brings a shard's result back to the caller's stream."""

    def __init__(self, devices):
        self.home = devices[0]
        self.devices = distinct(devices)
        self.cuda = self.home.type == "cuda"
        self._streams = {g: torch.cuda.Stream(g) for g in self.devices} \
            if self.cuda else {}

    def stream(self, device):
        return self._streams.get(device)

    def on(self, device):
        """A context that makes ``device``'s shard stream current."""
        return _on(self.stream(device))

    def start(self):
        """Order every shard stream after the work enqueued so far on the
        caller's current stream of the first device (the volume's upload
        and preprocessing)."""
        if self.cuda:
            ready = torch.cuda.current_stream(self.home).record_event()
            for s in self._streams.values():
                s.wait_event(ready)

    def scatter(self, t, device):
        """The caller's tensor ``t`` (on the first device) for use on
        ``device``'s shard stream."""
        if self.cuda and t.device == device:
            t.record_stream(self.stream(device))
            return t
        return hop(t, device, dst_stream=self.stream(device))

    def move(self, t, device):
        """A shard's tensor ``t`` on another shard's ``device``, in stream
        order on both."""
        return hop(t, device, self.stream(t.device), self.stream(device))

    def gather(self, t):
        """A shard's tensor ``t`` on the first device, for use on the
        caller's current stream."""
        src = self.stream(t.device)
        if self.cuda and t.device == self.home:
            caller = torch.cuda.current_stream(self.home)
            caller.wait_stream(src)
            t.record_stream(caller)
            return t
        return hop(t, self.home, src_stream=src)

    def run(self, fn):
        """``{device: fn(device)}`` for each distinct device; each call runs
        under ``torch.inference_mode`` with its device's shard stream
        current, on a thread of its own on CUDA. The first error is raised
        after every device's call has ended."""
        if not self.cuda:
            return {g: fn(g) for g in self.devices}

        def call(g):
            with torch.inference_mode(), torch.cuda.device(g), self.on(g):
                return fn(g)
        with ThreadPoolExecutor(len(self.devices), "shard") as pool:
            futures = {g: pool.submit(call, g) for g in self.devices}
        return {g: f.result() for g, f in futures.items()}
