"""Several processes, one per host: host-side coordination over a gloo group.

The counterpart of ``segmentation3d_tpu/parallel/distributed.py``. Batch
inference over several hosts is one process per host (``torchrun
--nproc_per_node 1 --nnodes N``), each slicing the case list round-robin
and running its slice on its own devices. What the processes share goes
through a ``torch.distributed`` gloo group: their rank and count, a
barrier, an object broadcast. Nothing here moves device data; collectives
between devices belong to training.

Every helper degrades to the identity in a single process, so the same
code serves one host and several.
"""
from __future__ import annotations

import os

import torch.distributed as dist


def initialize() -> bool:
    """Join the gloo group that torchrun's environment describes (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``). A no-op when a group
    is already initialised or ``WORLD_SIZE`` is unset or 1. Returns True
    when this call created the group (its caller then ends it with
    :func:`shutdown`)."""
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    dist.init_process_group("gloo", init_method="env://")
    return True


def shutdown() -> None:
    """End the process group, if one is initialised."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that should write checkpoints and logs."""
    return process_index() == 0


def barrier(name: str = "barrier") -> None:
    """Block until every process reaches this point (a no-op in one
    process). ``name`` labels the point in the error of a failed wait."""
    if process_count() > 1:
        try:
            dist.barrier()
        except RuntimeError as e:
            raise RuntimeError(f"barrier {name!r} failed: {e}") from e


def broadcast_from_primary(obj):
    """The value of ``obj`` on process 0, on every process (the identity in
    one process): keeps host-side decisions consistent across hosts."""
    if process_count() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
