"""Ranks of a gloo group on the CPU for the port's multi-rank training
tests. Imports torch and the port only (no JAX), so a spawned rank starts
quickly.

:func:`run_group` spawns ``world`` processes that join one gloo group and
run a list of scenarios in order; each scenario is a function of this
module, called as ``fn(rank, world, out_dir, **kwargs)``, that writes its
results under ``out_dir``. The tests hold those files against the JAX
package's mesh step and the port's one-process step.
"""
from __future__ import annotations

import os
import socket
import traceback

import numpy as np
import torch
import torch.distributed as dist

from segmentation3d_tpu_torch.config import EasyDict
from segmentation3d_tpu_torch.core.seg_train import train, train_step
from segmentation3d_tpu_torch.losses import create_loss
from segmentation3d_tpu_torch.models.vnet import BatchNorm, SegmentationNet, distribute_
from segmentation3d_tpu_torch.parallel.collectives import halo_exchange_z, world_mean
from segmentation3d_tpu_torch.parallel.train_mesh import TrainMesh

LR = {"sgd": 0.1, "adam": 1e-3}
#: seconds a rank may wait in a collective before the group gives up
TIMEOUT = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def loss_cfg(name):
    return EasyDict(name=name, obj_weight=None, focal_obj_alpha=0.25,
                    focal_gamma=2.0)


def _rank_main(rank, world, port, out_dir, scenarios):
    import datetime
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT))
    try:
        for name, kwargs in scenarios:
            try:
                globals()[name](rank, world, out_dir, **kwargs)
            except Exception:
                with open(os.path.join(out_dir, f"{kwargs.get('tag', name)}"
                                                f".rank{rank}.error"), "w") as f:
                    f.write(traceback.format_exc())
                raise
    finally:
        dist.destroy_process_group()


def run_group(world, out_dir, scenarios):
    """Run ``scenarios`` (``[(function name, kwargs)]``) on ``world`` ranks;
    raises when a rank fails."""
    import torch.multiprocessing as mp
    os.makedirs(out_dir, exist_ok=True)
    mp.start_processes(_rank_main, args=(world, free_port(), out_dir, scenarios),
                       nprocs=world, start_method="spawn")


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------

def step(rank, world, out_dir, *, tag, net_file, batch_file, act, kw, loss,
         opt, data, spatial=1, accum=1, dtype="float32"):
    """One training step of the net in ``net_file`` on the global batch in
    ``batch_file``, over a ``data x spatial`` mesh: this rank's rows and z
    planes, DDP, synced BatchNorm, halo convs. Writes the global loss and
    the state dict after the step."""
    from torch.nn.parallel import DistributedDataParallel
    mesh = TrainMesh(data, spatial, rank)
    net = SegmentationNet(1, 2, act=act, remat=True, **kw)
    net.load_state_dict(torch.load(net_file))
    net.to(getattr(torch, dtype))
    z_group = mesh.spatial_group()
    distribute_(net, dist.group.WORLD, z_group)
    model = DistributedDataParallel(net, broadcast_buffers=False)
    b = np.load(batch_file)
    rows = mesh.local_rows(b["x"].shape[0], accum)
    z = mesh.local_z(b["x"].shape[1])
    x = torch.from_numpy(b["x"][rows][:, z].astype(dtype))
    y = torch.from_numpy(b["y"][rows][:, z].copy())
    optimizer = torch.optim.SGD(net.parameters(), lr=LR[opt]) if opt == "sgd" \
        else torch.optim.Adam(net.parameters(), lr=LR[opt], eps=1e-8)
    got = train_step(model, optimizer, create_loss(loss_cfg(loss), 2, z_group=z_group),
                     x, y, accum=accum)
    np.savez(os.path.join(out_dir, f"{tag}.rank{rank}.npz"),
             loss=float(world_mean(got)),
             **{k: v.numpy() for k, v in net.state_dict().items()})


def batchnorm(rank, world, out_dir, *, tag, batch_file):
    """The synced BatchNorm alone on this rank's rows: the output, the
    gradients of ``sum(y * r)`` and the running statistics."""
    b = np.load(batch_file)
    per = b["x"].shape[0] // world
    sl = slice(rank * per, (rank + 1) * per)
    bn = BatchNorm(b["x"].shape[1])
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(b["w"]))
        bn.bias.copy_(torch.from_numpy(b["b"]))
    bn.group = dist.group.WORLD
    x = torch.from_numpy(b["x"][sl].copy()).requires_grad_(True)
    y = bn.train()(x)
    torch.sum(y * torch.from_numpy(b["r"][sl])).backward()
    np.savez(os.path.join(out_dir, f"{tag}.rank{rank}.npz"), y=y.detach().numpy(),
             gx=x.grad.numpy(), gw=bn.weight.grad.numpy(), gb=bn.bias.grad.numpy(),
             running_mean=bn.running_mean.numpy(), running_var=bn.running_var.numpy())


def halo_conv(rank, world, out_dir, *, tag, batch_file):
    """``halo_exchange_z`` + a conv with z padding 0 on this rank's z slab
    (the whole group is one spatial group): the output and the gradients of
    ``sum(out * r)`` for the input, the weight and the bias."""
    b = np.load(batch_file)
    z = TrainMesh(1, world, rank).local_z(b["x"].shape[2])
    x = torch.from_numpy(b["x"][:, :, z].copy()).requires_grad_(True)
    w = torch.from_numpy(b["w"]).requires_grad_(True)
    bias = torch.from_numpy(b["b"]).requires_grad_(True)
    out = torch.nn.functional.conv3d(halo_exchange_z(x, dist.group.WORLD), w, bias,
                                     padding=(0, 1, 1))
    torch.sum(out * torch.from_numpy(b["r"][:, :, z].copy())).backward()
    np.savez(os.path.join(out_dir, f"{tag}.rank{rank}.npz"), out=out.detach().numpy(),
             gx=x.grad.numpy(), gw=w.grad.numpy(), gb=bias.grad.numpy())


def train_error(rank, world, out_dir, *, tag, config):
    """``train`` on a config the group must refuse: writes the error."""
    try:
        train(config, device="cpu")
        msg = "no error"
    except (ValueError, RuntimeError) as e:
        msg = f"{type(e).__name__}: {e}"
    with open(os.path.join(out_dir, f"{tag}.rank{rank}.txt"), "w") as f:
        f.write(msg)
