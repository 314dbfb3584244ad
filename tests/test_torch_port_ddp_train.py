"""Data-parallel training over two ranks of a gloo group on the CPU, against
the JAX package's mesh step (``make_train_step`` / ``make_accum_train_step``
on ``make_mesh(2)``, conftest's virtual CPU devices) from the same weights
and batch, and against the port's one-process step; then ``seg_train``
itself as two torchrun ranks against one process.

One group of two spawned ranks (``torch_ddp_workers.py``) runs every
step scenario once per module and writes its results; the tests read
them. Bars are ``test_torch_port_train_step.py``'s: the loss within 1e-5
relative, the BatchNorm running statistics within 1e-5 of the tensor's
largest value, SGD's updated parameters within 1e-5 of the tensor's
largest value and the update within 1e-3 of its largest element (Adam:
that file's Adam bars). Both ranks must end with the same state.
"""
import copy
import csv
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_ddp_workers as workers
from phantoms import make_sphere_case, make_train_list, write_train_config
from segmentation3d_tpu.core.seg_train import make_accum_train_step, make_train_step
from segmentation3d_tpu.losses import create_loss as jax_create_loss
from segmentation3d_tpu.models.vnet import SegmentationNet as JaxNet
from segmentation3d_tpu.parallel import make_mesh, replicate, shard_batch
from segmentation3d_tpu.utils import model_io as jax_io
from segmentation3d_tpu_torch.core.seg_train import train, train_step
from segmentation3d_tpu_torch.losses import create_loss
from segmentation3d_tpu_torch.models.vnet import BatchNorm
from segmentation3d_tpu_torch.utils import model_io
from segmentation3d_tpu_torch.utils.model_io import params_from_jax
from test_torch_port_checkpoint import seeded_variables
from test_torch_port_train_step import (KW3, LR, _batch, _check_stats, _check_updates,
                                        _loss_cfg)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: tag: (act, loss, optimizer, grad_accum_steps, weight seed, batch seed)
SCENARIOS = {
    "dice_sgd": ("relu", "Dice", "sgd", 1, 5, 1),
    "focal_prelu_sgd": ("prelu", "Focal", "sgd", 1, 5, 2),
    "accum2_sgd": ("relu", "Dice", "sgd", 2, 6, 5),
    "dice_adam": ("relu", "Dice", "adam", 1, 5, 3),
}
BATCH = 4
NET = "".join(f"__C.net.{k} = {v!r}\n" for k, v in KW3.items())


def _gate_config(root, name, extra):
    lst = make_train_list(str(root / f"{name}.txt"),
                          [([str(root / "absent.nii.gz")], str(root / "absent_seg.nii.gz"))])
    return write_train_config(str(root / f"{name}.py"), lst, str(root / name),
                              crop_size=(16, 16, 16), batchsize=4,
                              extra=NET + "__C.general.num_gpus = 2\n" + extra)


#: 2-rank configs the group must refuse, with JAX's words (or the port's,
#: for a world larger than the mesh: JAX would leave devices idle)
GATES = {
    "batch_over_data": ("__C.train.batchsize = 3\n",
                        "batchsize 3 must divide over the data mesh axis (2)"),
    "micro_over_data": ("__C.train.grad_accum_steps = 4\n",
                        "microbatch 1 (batchsize 4 / grad_accum_steps 4) must divide "
                        "over the data mesh axis (2)"),
    "world_over_mesh": ("__C.general.num_gpus = 1\n",
                        "the config's mesh (1 x 1) uses 1 of the group's 2 ranks"),
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddp")
    out = str(root / "out")
    scenarios, inputs = [], {}
    for tag, (act, loss, opt, accum, wseed, bseed) in SCENARIOS.items():
        v, net = seeded_variables(act, 1, 2, seed=wseed, kw=KW3)
        x, y = _batch(BATCH, seed=bseed)
        net_file, batch_file = str(root / f"{tag}.pt"), str(root / f"{tag}.npz")
        torch.save(net.state_dict(), net_file)
        np.savez(batch_file, x=x, y=y)
        inputs[tag] = (v, net, x, y)
        scenarios.append(("step", dict(tag=tag, net_file=net_file, batch_file=batch_file,
                                       act=act, kw=KW3, loss=loss, opt=opt, data=2,
                                       accum=accum)))
    rng = np.random.default_rng(11)
    bn = dict(x=rng.normal(2.0, 3.0, (8, 3, 4, 5, 6)).astype(np.float32),
              r=rng.normal(size=(8, 3, 4, 5, 6)).astype(np.float32),
              w=rng.uniform(0.5, 1.5, 3).astype(np.float32),
              b=rng.normal(size=3).astype(np.float32))
    np.savez(str(root / "bn.npz"), **bn)
    scenarios.append(("batchnorm", dict(tag="bn", batch_file=str(root / "bn.npz"))))
    for tag, (extra, _) in GATES.items():
        scenarios.append(("train_error", dict(tag=tag, config=_gate_config(root, tag, extra))))
    workers.run_group(2, out, scenarios)
    return out, inputs, bn


def _results(out, tag):
    return [dict(np.load(os.path.join(out, f"{tag}.rank{r}.npz"))) for r in range(2)]


def _jax_mesh_step(v, act, loss, opt_name, x, y, accum):
    jnet = JaxNet(in_channels=1, out_channels=2, act=act, **KW3)
    opt = optax.sgd(LR[opt_name]) if opt_name == "sgd" else optax.adam(LR[opt_name])
    lf = jax_create_loss(_loss_cfg(loss), 2)
    mesh = make_mesh(2)
    step = make_train_step(jnet, lf, opt, mesh=mesh) if accum == 1 else \
        make_accum_train_step(jnet, lf, opt, accum, mesh=mesh)
    params = replicate(jax.tree_util.tree_map(jnp.asarray, v["params"]), mesh)
    stats = replicate(jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]), mesh)
    im, sg = shard_batch((jnp.asarray(x), jnp.asarray(y)), mesh)
    p2, s2, _, jloss = step(params, stats, replicate(opt.init(params), mesh), im, sg)
    want = params_from_jax({"params": jax.device_get(p2),
                            "batch_stats": jax.device_get(s2)})
    return float(jloss), {k: t.numpy() for k, t in want.items()}


def _port_step(net, loss, opt_name, x, y, accum):
    net = copy.deepcopy(net)
    opt = torch.optim.SGD(net.parameters(), lr=LR[opt_name]) if opt_name == "sgd" \
        else torch.optim.Adam(net.parameters(), lr=LR[opt_name], eps=1e-8)
    got = train_step(net, opt, create_loss(_loss_cfg(loss), 2), torch.from_numpy(x),
                     torch.from_numpy(y), accum=accum)
    return float(got), {k: t.numpy() for k, t in net.state_dict().items()}


@pytest.mark.parametrize("tag", list(SCENARIOS))
def test_two_ranks_match_jax_mesh_step(ranks, tag):
    out, inputs, _ = ranks
    act, loss, opt, accum, _, _ = SCENARIOS[tag]
    v, net, x, y = inputs[tag]
    old = {k: t.numpy().copy() for k, t in net.state_dict().items()}
    r0, r1 = _results(out, tag)
    for k in r0:  # every rank ends with the same weights and statistics
        np.testing.assert_array_equal(r1[k], r0[k], err_msg=k)
    jloss, want = _jax_mesh_step(v, act, loss, opt, x, y, accum)
    got_loss = float(r0.pop("loss"))
    assert abs(got_loss - jloss) <= 1e-5 * abs(jloss), (got_loss, jloss)
    _check_stats(r0, want)
    _check_updates(r0, old, want, opt)
    # and against the port's own step on the whole batch in one process
    ploss, one = _port_step(net, loss, opt, x, y, accum)
    assert abs(got_loss - ploss) <= 1e-5 * abs(ploss), (got_loss, ploss)
    _check_stats(r0, one)
    _check_updates(r0, old, one, opt)
    assert int(r0["in_block.conv.bn.num_batches_tracked"]) == accum


def test_synced_batchnorm_is_the_whole_batchs(ranks):
    """The synced BatchNorm on two halves against the unsynced one on the
    whole batch: output, input gradient, weight and bias gradient (summed
    over the ranks, as DDP's average times the ranks), running stats."""
    out, _, bn = ranks
    r = _results(out, "bn")
    ref = BatchNorm(3)
    with torch.no_grad():
        ref.weight.copy_(torch.from_numpy(bn["w"]))
        ref.bias.copy_(torch.from_numpy(bn["b"]))
    x = torch.from_numpy(bn["x"]).requires_grad_(True)
    y = ref.train()(x)
    torch.sum(y * torch.from_numpy(bn["r"])).backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.concatenate([r[0]["y"], r[1]["y"]]),
                               y.detach().numpy(), **tol)
    np.testing.assert_allclose(np.concatenate([r[0]["gx"], r[1]["gx"]]),
                               x.grad.numpy(), **tol)
    np.testing.assert_allclose(r[0]["gw"] + r[1]["gw"], ref.weight.grad.numpy(), **tol)
    np.testing.assert_allclose(r[0]["gb"] + r[1]["gb"], ref.bias.grad.numpy(), **tol)
    for k in ("running_mean", "running_var"):
        np.testing.assert_array_equal(r[0][k], r[1][k])
        np.testing.assert_allclose(r[0][k], getattr(ref, k).numpy(), **tol)


@pytest.mark.parametrize("tag", list(GATES))
def test_two_rank_gates(ranks, tag):
    out = ranks[0]
    for rank in range(2):
        with open(os.path.join(out, f"{tag}.rank{rank}.txt")) as f:
            msg = f.read()
        assert msg.startswith("ValueError: ") and GATES[tag][1] in msg, msg


# ---------------------------------------------------------------------------
# seg_train as two torchrun ranks against one process
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    """One SGD step of ``seg_train`` on two cases (batch 2, deterministic
    centre crops), with validation, in one process and as two ranks."""
    root = tmp_path_factory.mktemp("ddp_loop")
    data = str(root / "data")
    cases = [make_sphere_case(data, f"c{i}", shape_zyx=(24, 26, 22), seed=i)
             for i in range(2)]
    lst = make_train_list(str(root / "train.txt"), cases)
    val = make_train_list(str(root / "val.txt"), [cases[0]])
    cfgs = {}
    for name in ("one", "two"):
        os.makedirs(root / name)
        cfgs[name] = write_train_config(
            str(root / name / "train_cfg.py"), lst, str(root / name / "model"),
            crop_size=(16, 16, 16), epochs=1, batchsize=2, lr=0.1, save_epochs=1,
            sampling_method="CENTER",
            extra=NET + "__C.general.num_gpus = 2\n"
                        "__C.dataset.random_translation = [0.0, 0.0, 0.0]\n"
                        "__C.train.optimizer = 'sgd'\n"
                        f"__C.train.val_list = r'{val}'\n")
    train(cfgs["one"], device="cpu")
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "segmentation3d_tpu_torch.cli.seg_train",
             "-i", cfgs["two"], "-g", "-1"], env=env, cwd=str(root),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    return root, outs


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_two_ranks_write_the_one_process_files(loop):
    root, outs = loop
    one, two = str(root / "one" / "model"), str(root / "two" / "model")
    assert _files(one) == _files(two)
    assert "checkpoints/chk_1/params.pth" in _files(two)
    r1, r2 = (list(csv.reader(open(os.path.join(d, "train_loss.csv")))) for d in (one, two))
    assert r1[0] == r2[0] == ["epoch", "batch", "loss"] and len(r1) == len(r2) == 2
    assert r2[1][:2] == r1[1][:2]
    assert float(r2[1][2]) == pytest.approx(float(r1[1][2]), rel=1e-5)
    log = open(os.path.join(two, "train_log.txt")).read().splitlines()
    assert "training group: backend gloo, world 2, devices by rank ['cpu', 'cpu']" in log[0]
    assert "2 device(s) (data 2 x spatial 1), rank 0 on cpu" in log[1]
    # validation once, on rank 0 alone
    assert len(list(csv.reader(open(os.path.join(two, "val_dice.csv"))))) == 2
    assert [o.count("val dice:") for o in outs] == [1, 0]
    assert "backend gloo" in outs[1] and "rank 1 on cpu" in outs[1]


def test_two_rank_checkpoint_is_the_one_process_one(loop):
    """JAX's bar for a two-process SGD step (tests/test_distributed.py):
    every tensor within 1e-5; the keys are the one-process checkpoint's
    (no ``module.`` prefix), and it loads in the JAX package."""
    root, _ = loop
    a, b = (model_io.load_checkpoint_payload(
        str(root / name / "model" / "checkpoints" / "chk_1")) for name in ("one", "two"))
    assert list(b["state_dict"]) == list(a["state_dict"])
    for k, t in a["state_dict"].items():
        np.testing.assert_allclose(b["state_dict"][k].numpy(), t.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    variables, payload = jax_io.load_checkpoint(
        str(root / "two" / "model" / "checkpoints" / "chk_1"))
    jnet = JaxNet(in_channels=1, out_channels=2, **payload["net_kwargs"])
    x = np.random.default_rng(0).normal(size=(1, 16, 16, 16, 1)).astype(np.float32)
    assert np.isfinite(np.asarray(jnet.apply(variables, jnp.asarray(x), train=False))).all()
