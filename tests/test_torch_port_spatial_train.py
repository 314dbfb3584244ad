"""The spatial training shard (``cfg.tpu.mesh.spatial``) over ranks of a
gloo group on the CPU: each rank holds a z slab of every crop, its 3^3
convs exchange a halo plane with their z neighbours, BatchNorm and Dice
sum over the slabs. Held against the JAX package's mesh step
(``make_train_step(mesh=make_mesh(2|4, spatial=2))``, conftest's virtual
CPU devices) from the same weights and batch, and against the port's
one-process step.

Bars are ``test_torch_port_train_step.py``'s (SGD, float32). The nets are
that file's three-level one on a 32 x 16 x 16 crop: the full-depth base-2
net of ``tests/test_spatial_train.py`` sees four values per channel in its
deepest BatchNorm here, where float32 rounding moves an update by up to
0.6% of its largest element between two runs of the port itself; in
float64 that net's sharded step is held to the one-process one within
1e-9.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import torch_ddp_workers as workers
from phantoms import write_train_config
from segmentation3d_tpu.core.seg_train import make_train_step
from segmentation3d_tpu.losses import create_loss as jax_create_loss
from segmentation3d_tpu.models.vnet import SegmentationNet as JaxNet
from segmentation3d_tpu.parallel import make_mesh, replicate, shard_batch
from segmentation3d_tpu_torch.core.seg_train import train_step
from segmentation3d_tpu_torch.losses import create_loss
from segmentation3d_tpu_torch.models.vnet import SegmentationNet, init_like_flax_
from segmentation3d_tpu_torch.utils.model_io import params_from_jax
from test_torch_port_checkpoint import seeded_variables
from test_torch_port_train_step import KW3, LR, _check_stats, _check_updates, _loss_cfg

CROP = (32, 16, 16)  # z y x: 16 planes per rank at full resolution
FULL_DEPTH = dict(base_channels=2)  # tests/test_spatial_train.py:_tiny_setup's net
#: mesh (data, spatial) per step scenario
MESHES = {"spatial2": (1, 2), "data2_spatial2": (2, 2)}
#: 2-rank configs the group must refuse, with JAX's words
GATES = {
    "crop_z": ("__C.dataset.crop_size = [32, 32, 16]\n",
               "crop_size z = 16 must divide by spatial mesh 2 * max_stride 16 so "
               "every resolution level shards evenly"),
    "packed_domain": ("__C.tpu.conv_backend = 'packed_domain'\n",
                      "cfg.tpu.mesh.spatial > 1 requires conv_backend 'direct' or "
                      "'window'"),
}


def _batch(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2,) + CROP + (1,)).astype(dtype)
    y = rng.integers(0, 2, size=(2,) + CROP).astype(np.int32)
    return x, y


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("spatial")
    out = str(root / "out")
    v, net = seeded_variables("relu", 1, 2, seed=5, kw=KW3)
    x, y = _batch(0)
    torch.save(net.state_dict(), str(root / "kw3.pt"))
    np.savez(str(root / "batch.npz"), x=x, y=y)
    full = init_like_flax_(SegmentationNet(1, 2, **FULL_DEPTH),
                           torch.Generator().manual_seed(0))
    torch.save(full.state_dict(), str(root / "full.pt"))
    x64, y64 = _batch(1, np.float64)
    np.savez(str(root / "batch64.npz"), x=x64, y=y64)
    rng = np.random.default_rng(2)
    halo = dict(x=rng.normal(size=(2, 3, 8, 5, 6)).astype(np.float32),
                w=rng.normal(size=(4, 3, 3, 3, 3)).astype(np.float32),
                b=rng.normal(size=4).astype(np.float32),
                r=rng.normal(size=(2, 4, 8, 5, 6)).astype(np.float32))
    np.savez(str(root / "halo.npz"), **halo)

    def step(tag, data, net_file, batch_file, kw, dtype="float32"):
        return ("step", dict(tag=tag, net_file=str(root / net_file),
                             batch_file=str(root / batch_file), act="relu", kw=kw,
                             loss="Dice", opt="sgd", data=data, spatial=2, dtype=dtype))
    two = [("halo_conv", dict(tag="halo", batch_file=str(root / "halo.npz"))),
           step("spatial2", 1, "kw3.pt", "batch.npz", KW3),
           step("spatial2_f64", 1, "full.pt", "batch64.npz", FULL_DEPTH, "float64")]
    for tag, (extra, _) in GATES.items():
        cfg = write_train_config(
            str(root / f"{tag}.py"), str(root / "absent.txt"), str(root / tag),
            crop_size=(32, 32, 32), batchsize=2,
            extra="__C.tpu = edict()\n__C.tpu.mesh = edict()\n__C.tpu.mesh.data = -1\n"
                  "__C.tpu.mesh.spatial = 2\n" + extra)
        two.append(("train_error", dict(tag=tag, config=cfg)))
    with open(root / "absent.txt", "w") as f:
        f.write(f"1\n{root / 'a.nii.gz'}\n{root / 'a_seg.nii.gz'}\n")
    workers.run_group(2, out, two)
    workers.run_group(4, out, [step("data2_spatial2", 2, "kw3.pt", "batch.npz", KW3)])
    return out, v, net, (x, y), full, (x64, y64), halo


def _results(out, tag, world):
    return [dict(np.load(os.path.join(out, f"{tag}.rank{r}.npz"))) for r in range(world)]


def _port_step(net, x, y, dtype=torch.float32):
    import copy
    net = copy.deepcopy(net).to(dtype)
    opt = torch.optim.SGD(net.parameters(), lr=LR["sgd"])
    got = train_step(net, opt, create_loss(_loss_cfg("Dice"), 2),
                     torch.from_numpy(x), torch.from_numpy(y))
    return float(got), {k: t.numpy() for k, t in net.state_dict().items()}


def _jax_spatial_step(v, x, y, data):
    jnet = JaxNet(in_channels=1, out_channels=2, **KW3)
    opt = optax.sgd(LR["sgd"])
    mesh = make_mesh(2 * data, spatial=2)
    step = make_train_step(jnet, jax_create_loss(_loss_cfg("Dice"), 2), opt, mesh=mesh)
    params = replicate(jax.tree_util.tree_map(jnp.asarray, v["params"]), mesh)
    stats = replicate(jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]), mesh)
    im, sg = shard_batch((jnp.asarray(x), jnp.asarray(y)), mesh)
    p2, s2, _, loss = step(params, stats, replicate(opt.init(params), mesh), im, sg)
    want = params_from_jax({"params": jax.device_get(p2),
                            "batch_stats": jax.device_get(s2)})
    return float(loss), {k: t.numpy() for k, t in want.items()}


def test_halo_conv_is_the_unsharded_conv(ranks):
    """halo_exchange_z + a conv without z padding on two z slabs against
    the SAME conv of the whole input: output and every gradient."""
    out, *_, halo = ranks
    r = _results(out, "halo", 2)
    x = torch.from_numpy(halo["x"]).requires_grad_(True)
    w = torch.from_numpy(halo["w"]).requires_grad_(True)
    b = torch.from_numpy(halo["b"]).requires_grad_(True)
    ref = F.conv3d(x, w, b, padding=1)
    torch.sum(ref * torch.from_numpy(halo["r"])).backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.concatenate([r[0]["out"], r[1]["out"]], 2),
                               ref.detach().numpy(), **tol)
    np.testing.assert_allclose(np.concatenate([r[0]["gx"], r[1]["gx"]], 2),
                               x.grad.numpy(), **tol)
    np.testing.assert_allclose(r[0]["gw"] + r[1]["gw"], w.grad.numpy(), **tol)
    np.testing.assert_allclose(r[0]["gb"] + r[1]["gb"], b.grad.numpy(), **tol)


@pytest.mark.parametrize("tag", list(MESHES))
def test_spatial_step_matches_jax_mesh_step(ranks, tag):
    out, v, net, (x, y), *_ = ranks
    data, spatial = MESHES[tag]
    old = {k: t.numpy().copy() for k, t in net.state_dict().items()}
    res = _results(out, tag, data * spatial)
    for other in res[1:]:  # every rank ends with the same weights and statistics
        for k in res[0]:
            np.testing.assert_array_equal(other[k], res[0][k], err_msg=k)
    got = res[0]
    got_loss = float(got.pop("loss"))
    jloss, want = _jax_spatial_step(v, x, y, data)
    assert abs(got_loss - jloss) <= 1e-5 * abs(jloss), (got_loss, jloss)
    _check_stats(got, want)
    _check_updates(got, old, want, "sgd")
    ploss, one = _port_step(net, x, y)
    assert abs(got_loss - ploss) <= 1e-5 * abs(ploss), (got_loss, ploss)
    _check_stats(got, one)
    _check_updates(got, old, one, "sgd")


def test_full_depth_spatial_step_is_exact_in_float64(ranks):
    """The full-depth net (1 plane per rank at its deepest level, so every
    halo there is a whole neighbour) in float64: the sharded step is the
    one-process step to rounding."""
    out, *_, full, (x64, y64), _ = ranks
    got = _results(out, "spatial2_f64", 2)[0]
    ploss, one = _port_step(full, x64, y64, torch.float64)
    assert abs(float(got.pop("loss")) - ploss) <= 1e-12
    for k, t in one.items():
        np.testing.assert_allclose(got[k], t, rtol=1e-9, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("tag", list(GATES))
def test_spatial_gates(ranks, tag):
    out = ranks[0]
    for rank in range(2):
        with open(os.path.join(out, f"{tag}.rank{rank}.txt")) as f:
            msg = f.read()
        assert msg.startswith("ValueError: ") and GATES[tag][1] in msg, msg
