"""The training mesh: which rank holds which rows and z planes of a batch.

The counterpart of ``segmentation3d_tpu/parallel/mesh.py:make_mesh`` and of
the mesh rules of ``segmentation3d_tpu/core/seg_train.py:train`` for
training. One process trains on one device (a rank), so the mesh is a
``(data, spatial)`` grid of ranks: rank ``r = d * S + s`` holds data shard
``d`` of each (micro)batch and z slab ``s`` of each crop, as JAX's
``make_mesh(n, spatial=S)`` lays ``n`` devices out row by row.

:meth:`TrainMesh.from_config` reads ``cfg.tpu.mesh.data``,
``cfg.tpu.mesh.spatial`` and ``cfg.general.num_gpus`` with JAX's precedence
and clamps to the devices there are; :meth:`TrainMesh.check` raises JAX's
errors with their messages. Nothing here needs a process group except
:meth:`TrainMesh.spatial_group`.
"""
from __future__ import annotations

from dataclasses import dataclass


def mesh_shape(num_devices: int, available: int, spatial: int = 1):
    """``(data, spatial)`` of ``make_mesh(num_devices, spatial=spatial)``
    over ``available`` devices: ``num_devices <= 0`` means all of them, more
    than there are is clamped, and the total must divide by ``spatial``."""
    n = available if num_devices is None or num_devices <= 0 \
        else min(int(num_devices), available)
    spatial = max(1, int(spatial))
    if spatial > 1 and n % spatial != 0:
        raise ValueError(f"{n} device(s) do not divide over a spatial "
                         f"mesh axis of {spatial}")
    return n // spatial, spatial


def requested_devices(cfg) -> tuple[int, int]:
    """``(devices, spatial)`` a config asks for, as the JAX trainer reads
    it: ``cfg.tpu.mesh.data`` wins, else ``cfg.general.num_gpus``; -1 (the
    template's ``mesh.data``) or 0 means every device; ``devices`` is the
    total, ``data * spatial``."""
    mesh_cfg = cfg.get("tpu", {}).get("mesh", {})
    spatial = max(1, int(mesh_cfg.get("spatial", 1) or 1))
    data = int(mesh_cfg.get("data", 0) or 0) \
        or int(cfg.general.get("num_gpus", -1) or -1)
    return (data * spatial if data > 0 else -1), spatial


@dataclass(frozen=True)
class TrainMesh:
    """A ``data x spatial`` grid of ranks and this process's ``rank`` in it."""
    data: int = 1
    spatial: int = 1
    rank: int = 0

    @classmethod
    def from_config(cls, cfg, available: int, rank: int = 0) -> "TrainMesh":
        """The mesh of ``cfg`` over ``available`` devices (ranks)."""
        devices, spatial = requested_devices(cfg)
        data, spatial = mesh_shape(devices, available, spatial)
        return cls(data, spatial, rank)

    @property
    def size(self) -> int:
        return self.data * self.spatial

    @property
    def data_index(self) -> int:
        return self.rank // self.spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.spatial

    def check(self, *, batchsize: int, crop_z: int, max_stride: int,
              grad_accum: int = 1, conv_backend: str = "direct",
              hosts: int = 1) -> None:
        """The JAX trainer's rules for this mesh, in its order and words
        (``hosts``: the processes JAX would count, one per node)."""
        if self.spatial > 1:
            if conv_backend == "packed_domain":
                raise ValueError(
                    "cfg.tpu.mesh.spatial > 1 requires conv_backend 'direct' or "
                    "'window' (the packed-domain forward's channel-minor "
                    "reshapes do not GSPMD-partition along z)")
            if crop_z % (self.spatial * max_stride) != 0:
                raise ValueError(
                    f"crop_size z = {crop_z} must divide by "
                    f"spatial mesh {self.spatial} * max_stride {max_stride} so every "
                    "resolution level shards evenly")
        if batchsize % self.data != 0 and self.data > 1:
            raise ValueError(f"batchsize {batchsize} must divide over the "
                             f"data mesh axis ({self.data})")
        if batchsize % hosts != 0:
            raise ValueError(f"batchsize {batchsize} must divide over "
                             f"{hosts} processes")
        if grad_accum > 1:
            if batchsize % grad_accum != 0:
                raise ValueError(f"batchsize {batchsize} must divide by "
                                 f"grad_accum_steps {grad_accum}")
            micro = batchsize // grad_accum
            if self.data > 1 and micro % self.data != 0:
                raise ValueError(
                    f"microbatch {micro} (batchsize {batchsize} / "
                    f"grad_accum_steps {grad_accum}) must divide over the "
                    f"data mesh axis ({self.data})")

    def local_rows(self, batch: int, accum: int = 1) -> list:
        """The positions in the global batch that this rank holds, in the
        order it trains them: microbatch ``i`` is global rows ``[i * mb, (i
        + 1) * mb)`` sharded over ``data`` (JAX's ``make_accum_train_step``
        reshape), so data shard ``d`` holds ``i * mb + d * mb / n`` and the
        ``mb / n - 1`` rows after it, microbatch after microbatch."""
        mb = batch // accum
        per = mb // self.data
        d = self.data_index
        return [i * mb + d * per + j for i in range(accum) for j in range(per)]

    def local_z(self, crop_z: int) -> slice:
        """This rank's planes of a crop of ``crop_z`` planes."""
        per = crop_z // self.spatial
        s = self.spatial_index
        return slice(s * per, (s + 1) * per)

    def spatial_ranks(self, rank: int | None = None) -> list:
        """The ranks that share ``rank``'s rows (its spatial group)."""
        d = (self.rank if rank is None else rank) // self.spatial
        return list(range(d * self.spatial, (d + 1) * self.spatial))

    def spatial_group(self):
        """This rank's spatial process group (None when ``spatial`` is 1).
        Every rank of the world must call it, in the same order: each
        spatial group is created on every rank."""
        if self.spatial == 1:
            return None
        import torch.distributed as dist
        mine = None
        for d in range(self.data):
            ranks = self.spatial_ranks(d * self.spatial)
            group = dist.new_group(ranks)
            if self.rank in ranks:
                mine = group
        return mine
