"""The port's training mesh (``parallel/train_mesh.py``) against the JAX
package's ``make_mesh`` on conftest's 8 virtual CPU devices, the backend
rule of ``parallel/distributed.py:training_rule``, and ``seg_train``'s
start (one process, torchrun's group, or one spawned rank per GPU). No
process is started."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from segmentation3d_tpu.parallel import make_mesh, shard_batch
from segmentation3d_tpu_torch.config import EasyDict
from segmentation3d_tpu_torch.core import seg_train as port_train
from segmentation3d_tpu_torch.parallel import distributed
from segmentation3d_tpu_torch.parallel.train_mesh import TrainMesh, requested_devices


def _cfg(data=None, spatial=None, num_gpus=None):
    mesh = EasyDict()
    if data is not None:
        mesh.data = data
    if spatial is not None:
        mesh.spatial = spatial
    general = EasyDict()
    if num_gpus is not None:
        general.num_gpus = num_gpus
    return EasyDict(general=general, tpu=EasyDict(mesh=mesh))


def _jax_mesh(cfg, available):
    """The JAX trainer's mesh for ``cfg`` (``core/seg_train.py:463-468``)
    over the first ``available`` devices."""
    mesh_cfg = cfg.get("tpu", {}).get("mesh", {})
    spatial = max(1, int(mesh_cfg.get("spatial", 1) or 1))
    data_size = int(mesh_cfg.get("data", 0)) \
        or int(cfg.general.get("num_gpus", -1) or -1)
    return make_mesh(data_size * spatial if data_size > 0 else -1,
                     devices=jax.devices()[:available], spatial=spatial)


@pytest.mark.parametrize("kw,available", [
    (dict(data=-1), 8), (dict(data=-1), 1), (dict(data=2), 8),
    (dict(data=2, num_gpus=4), 1), (dict(data=0, num_gpus=4), 8),
    (dict(num_gpus=-1), 3), (dict(data=12), 8), (dict(), 8),
    (dict(data=-1, spatial=2), 8), (dict(data=2, spatial=2), 8),
    (dict(data=1, spatial=4), 8), (dict(num_gpus=2, spatial=2), 8),
    (dict(data=3, spatial=2), 4),
])
def test_mesh_is_jaxs(kw, available):
    """Precedence (mesh.data, then num_gpus, then every device) and
    clamping, as the JAX trainer builds its mesh."""
    cfg = _cfg(**kw)
    want = _jax_mesh(cfg, available)
    got = TrainMesh.from_config(cfg, available)
    shape = (want.shape["data"], want.shape.get("spatial", 1))
    assert (got.data, got.spatial) == shape
    assert got.size == want.devices.size


@pytest.mark.parametrize("kw,available", [
    (dict(spatial=2), 1), (dict(data=-1, spatial=3), 8), (dict(spatial=3), 4)])
def test_mesh_error_is_jaxs(kw, available):
    cfg = _cfg(**kw)
    with pytest.raises(ValueError) as want:
        _jax_mesh(cfg, available)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        TrainMesh.from_config(cfg, available)
    assert "do not divide over a spatial mesh axis" in str(want.value)


def test_template_default_is_every_device():
    """The template's mesh.data = -1 asks for every device."""
    import segmentation3d_tpu_torch.config as config
    import os
    cfg = config.load_config(os.path.join(os.path.dirname(config.__file__),
                                          "template_config.py"))
    assert requested_devices(cfg) == (-1, 1)
    assert TrainMesh.from_config(cfg, 4).size == 4


# JAX's messages, core/seg_train.py:469-487 and :505-516
@pytest.mark.parametrize("mesh,kw,message", [
    ((1, 2), dict(conv_backend="packed_domain"),
     "cfg.tpu.mesh.spatial > 1 requires conv_backend 'direct' or 'window' (the "
     "packed-domain forward's channel-minor reshapes do not GSPMD-partition "
     "along z)"),
    ((1, 2), dict(crop_z=16),
     "crop_size z = 16 must divide by spatial mesh 2 * max_stride 16 so every "
     "resolution level shards evenly"),
    ((2, 1), dict(batchsize=3), "batchsize 3 must divide over the data mesh axis (2)"),
    ((1, 1), dict(batchsize=3, hosts=2), "batchsize 3 must divide over 2 processes"),
    ((1, 1), dict(grad_accum=3), "batchsize 4 must divide by grad_accum_steps 3"),
    ((2, 1), dict(grad_accum=4),
     "microbatch 1 (batchsize 4 / grad_accum_steps 4) must divide over the data "
     "mesh axis (2)"),
])
def test_check_messages_are_jaxs(mesh, kw, message):
    args = dict(batchsize=4, crop_z=32, max_stride=16)
    args.update(kw)
    with pytest.raises(ValueError, match=re.escape(message)):
        TrainMesh(*mesh).check(**args)


def test_check_passes_what_jax_takes():
    TrainMesh(2, 2).check(batchsize=4, crop_z=32, max_stride=16, grad_accum=2)
    TrainMesh(1, 1).check(batchsize=3, crop_z=16, max_stride=16)


@pytest.mark.parametrize("data,spatial,batch,accum", [
    (2, 1, 4, 1), (2, 1, 4, 2), (4, 1, 8, 2), (2, 2, 8, 2), (8, 1, 16, 1),
    (2, 1, 8, 4)])
def test_local_rows_are_jaxs_shards(data, spatial, batch, accum):
    """The rows each data shard holds under JAX's layout: the batch sharded
    over 'data' (accum 1), or reshaped to [accum, mb] with the microbatch
    axis sharded over 'data' (make_accum_train_step)."""
    mesh = make_mesh(data * spatial, spatial=spatial)
    rows = jnp.arange(batch)
    if accum == 1:
        arr = jax.device_put(rows, NamedSharding(mesh, P("data")))
    else:
        arr = jax.device_put(rows.reshape(accum, batch // accum),
                             NamedSharding(mesh, P(None, "data")))
    # a shard of [accum, mb] lists its rows microbatch after microbatch
    by_device = {s.device: np.asarray(s.data).ravel().tolist()
                 for s in arr.addressable_shards}
    devices = np.asarray(mesh.devices).reshape(data, spatial)
    for rank in range(data * spatial):
        m = TrainMesh(data, spatial, rank)
        want = by_device[devices[m.data_index, m.spatial_index]]
        assert m.local_rows(batch, accum) == want, (rank, want)


@pytest.mark.parametrize("data,spatial", [(1, 2), (2, 2), (2, 4), (1, 8)])
def test_local_z_is_jaxs_shard(data, spatial):
    mesh = make_mesh(data * spatial, spatial=spatial)
    crop_z = 16 * spatial
    zs = jnp.broadcast_to(jnp.arange(crop_z), (2 * data, crop_z))
    arr = shard_batch(zs, mesh)
    by_device = {s.device: np.asarray(s.data)[0] for s in arr.addressable_shards}
    devices = np.asarray(mesh.devices).reshape(data, spatial)
    for rank in range(data * spatial):
        m = TrainMesh(data, spatial, rank)
        z = m.local_z(crop_z)
        want = by_device[devices[m.data_index, m.spatial_index]]
        assert list(range(crop_z))[z] == want.tolist()
        assert m.spatial_ranks() == [r for r in range(data * spatial)
                                     if r // spatial == m.data_index]


def test_one_rank_mesh_has_no_group():
    assert TrainMesh(2, 1, 1).spatial_group() is None


@pytest.mark.parametrize("local_world,gpus,first,backend,devices", [
    (2, 0, -1, "gloo", ["cpu", "cpu"]),
    (2, 2, 0, "nccl", ["cuda:0", "cuda:1"]),
    (4, 8, 2, "nccl", ["cuda:2", "cuda:3", "cuda:4", "cuda:5"]),
    (2, 1, 0, "gloo", ["cuda:0", "cuda:0"]),
    (4, 3, 1, "gloo", ["cuda:1", "cuda:2", "cuda:1", "cuda:2"]),
])
def test_training_rule(local_world, gpus, first, backend, devices):
    got = distributed.training_rule(local_world, gpus, first)
    assert got[0] == backend and [str(d) for d in got[1]] == devices


def test_training_rule_needs_a_gpu():
    with pytest.raises(RuntimeError, match="no CUDA device from cuda:2 on"):
        distributed.training_rule(2, 2, 2)


def test_launcher_counts(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.launcher_counts() == dict(rank=0, world=1, local_rank=0,
                                                 local_world=1)
    monkeypatch.setenv("RANK", "5")
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert distributed.launcher_counts() == dict(rank=5, world=8, local_rank=1,
                                                 local_world=4)


def _write_cfg(tmp_path, body):
    path = tmp_path / "cfg.py"
    path.write_text("from easydict import EasyDict as edict\n__C = edict()\ncfg = __C\n"
                    "__C.general = edict()\n__C.general.save_dir = 'unused'\n"
                    "__C.tpu = edict()\n__C.tpu.mesh = edict()\n" + body)
    return str(path)


@pytest.mark.parametrize("body,gpus,first,want", [
    ("__C.tpu.mesh.data = -1\n", 4, 0, 4),
    ("__C.tpu.mesh.data = -1\n", 4, 1, 3),
    ("__C.tpu.mesh.data = 2\n", 4, 0, 2),
    ("__C.general.num_gpus = 8\n", 4, 0, 4),
    ("__C.tpu.mesh.data = -1\n__C.tpu.mesh.spatial = 2\n", 4, 0, 4),
    ("__C.tpu.mesh.data = 1\n", 4, 0, 1),
    ("__C.tpu.mesh.data = -1\n", 4, -1, 1),  # the CPU counts as one device
])
def test_spawn_count(tmp_path, monkeypatch, body, gpus, first, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: gpus)
    assert port_train.spawn_count(_write_cfg(tmp_path, body), first) == want


def test_spawn_count_keeps_jaxs_error(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    cfg = _write_cfg(tmp_path, "__C.tpu.mesh.spatial = 2\n")
    with pytest.raises(ValueError, match="3 device\\(s\\) do not divide"):
        port_train.spawn_count(cfg, 0)


def test_train_ranks_routes(tmp_path, monkeypatch):
    """One process, a spawned rank per GPU, or torchrun's group: each
    spawned rank gets torchrun's environment and takes the torchrun route."""
    import torch.multiprocessing as mp
    cfg = _write_cfg(tmp_path, "__C.tpu.mesh.data = -1\n")
    calls = []
    monkeypatch.setattr(port_train, "train",
                        lambda c, gpu_id=0, device=None, stats=None:
                        calls.append(("train", gpu_id, device)) or "dir")
    # set, then unset: what the spawned rank writes is undone at teardown
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
              "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.setenv(k, "0")
        monkeypatch.delenv(k)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert port_train.train_ranks(cfg, 0) == "dir"
    assert calls == [("train", 0, None)]

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    spawned = {}
    monkeypatch.setattr(mp, "start_processes",
                        lambda fn, args, nprocs, start_method: spawned.update(
                            fn=fn, args=args, nprocs=nprocs, method=start_method))
    assert port_train.train_ranks(cfg, 1) == "unused"
    assert spawned["nprocs"] == 2 and spawned["method"] == "spawn"
    assert spawned["args"][:3] == (cfg, 1, 2)

    # a spawned rank: torchrun's environment, then the group route
    joined = []
    monkeypatch.setattr(distributed, "join_training",
                        lambda first: joined.append(first) or torch.device("cpu"))
    monkeypatch.setattr(distributed, "shutdown", lambda: joined.append("left"))
    calls.clear()
    spawned["fn"](1, *spawned["args"])
    import os
    assert [os.environ[k] for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE",
                                    "LOCAL_WORLD_SIZE", "MASTER_ADDR")] == \
        ["1", "1", "2", "2", "127.0.0.1"]
    assert joined == [1, "left"] and calls == [("train", 0, torch.device("cpu"))]
