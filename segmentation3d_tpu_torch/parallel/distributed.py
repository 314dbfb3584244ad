"""Several processes: their group, rank and count.

The counterpart of ``segmentation3d_tpu/parallel/distributed.py``. Batch
inference over several hosts is one process per host (``torchrun
--nproc_per_node 1 --nnodes N``), each slicing the case list round-robin
and running its slice on its own devices; :func:`initialize` joins it to
a gloo group that carries only host-side coordination (rank and count, a
barrier, an object broadcast).

Training over several GPUs is one process per GPU (a rank);
:func:`join_training` joins it to a group whose collectives move device
data (``parallel/collectives.py``, DDP). Its backend and each rank's
device follow one rule, decided from the hardware and the launcher's
counts before the group is created (:func:`training_rule`).

Every helper degrades to the identity in a single process, so the same
code serves one host and several.
"""
from __future__ import annotations

import os

import torch
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


def launcher_counts() -> dict:
    """torchrun's counts from the environment: ``rank``, ``world``,
    ``local_rank``, ``local_world`` (a launcher that sets only ``RANK``
    and ``WORLD_SIZE`` runs every rank on one node)."""
    rank, world = int(os.environ.get("RANK", "0")), int(os.environ.get("WORLD_SIZE", "1"))
    return dict(rank=rank, world=world,
                local_rank=int(os.environ.get("LOCAL_RANK", str(rank))),
                local_world=int(os.environ.get("LOCAL_WORLD_SIZE", str(world))))


def training_rule(local_world: int, gpus: int, first_gpu: int = 0):
    """``(backend, devices)``: the backend of a training group and the device
    of each of a node's ``local_world`` ranks, given the node's ``gpus`` and
    the first one to use (``first_gpu < 0``: the CPU).

    - the CPU: gloo, every rank on the CPU;
    - at least one GPU per rank from ``first_gpu`` on: NCCL, local rank
      ``i`` on ``cuda:first_gpu + i``;
    - fewer: the ranks share the GPUs round-robin, over gloo (NCCL does
      not put two ranks on one GPU).
    """
    if first_gpu < 0:
        return "gloo", [torch.device("cpu")] * local_world
    have = gpus - first_gpu
    if have <= 0:
        raise RuntimeError(
            f"no CUDA device from cuda:{first_gpu} on ({gpus} CUDA device(s)); "
            "pass -g -1 to train on the CPU")
    backend = "nccl" if have >= local_world else "gloo"
    return backend, [torch.device("cuda", first_gpu + i % have)
                     for i in range(local_world)]


def join_training(first_gpu: int = 0):
    """Join the training group that torchrun's environment describes
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; ``LOCAL_RANK``
    and ``LOCAL_WORLD_SIZE`` when set) by :func:`training_rule`, printed
    first (backend, world, each local rank's device). Returns this rank's
    device. A rank that cannot join raises: no other backend is tried."""
    counts = launcher_counts()
    gpus = torch.cuda.device_count() if first_gpu >= 0 else 0
    backend, devices = training_rule(counts["local_world"], gpus, first_gpu)
    device = devices[counts["local_rank"]]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    print(f"training group: backend {backend}, world {counts['world']}, "
          f"rank {counts['rank']} on {device}; node's ranks on "
          f"{[str(d) for d in devices]}", flush=True)
    dist.init_process_group(backend, init_method="env://", rank=counts["rank"],
                            world_size=counts["world"])
    return device
