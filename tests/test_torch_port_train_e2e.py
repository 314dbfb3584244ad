"""The training slice end to end on the CPU: ``validate_cases`` and
``seg_train`` of the port against the JAX package's on sphere phantoms,
checkpoints crossing both ways, resume, the save-dir rules, ``--folds``.

Bars:

- ``validate_cases`` (float32, the same weights, whole volume and slabs):
  per-class Dice within 1e-3 of JAX's (a few argmax near-ties may flip);
- ``seg_train`` against JAX's ``train`` from one common starting checkpoint
  (``resume_epoch = 0``: the same weights, a fresh Adam, the sampler and
  crop streams from the seed in both): the first three ``train_loss.csv``
  rows within 1e-3 relative (Adam's first steps move elements whose
  gradient is rounding noise by a full ``lr`` of either sign, so the runs
  drift apart slowly), the same files in the save dir (the optimizer state
  as ``opt_state.pt`` in the port, ``opt_state.pkl`` in JAX);
- the port's checkpoint in JAX's ``load_checkpoint``: the eval forward
  within 1e-4 of the port's; in JAX's ``load_seg_model`` +
  ``segmentation``: its mask agrees with the port's ``seg_infer`` on
  >= 0.98 of voxels (the repo's bar), float32;
- resume: a run resumed from its ``chk_2`` ends with the uninterrupted
  run's ``chk_4`` within 1e-6 (one case, centre crops without jitter, so
  the data stream does not depend on where a run starts).
"""
import csv
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phantoms import make_sphere_case, make_train_list, write_train_config
from segmentation3d_tpu.core import folds as jax_folds
from segmentation3d_tpu.core.seg_infer import load_seg_model as jax_load_seg_model
from segmentation3d_tpu.core.seg_infer import segmentation as jax_segmentation
from segmentation3d_tpu.core.seg_train import train as jax_train
from segmentation3d_tpu.core.validation import validate_cases as jax_validate
from segmentation3d_tpu.io import read_image as jax_read
from segmentation3d_tpu.models.vnet import SegmentationNet as JaxNet
from segmentation3d_tpu.utils import model_io as jax_io
from segmentation3d_tpu.utils.normalizer import AdaptiveNormalizer as JaxAdaptive
from segmentation3d_tpu_torch.cli.seg_infer import main as seg_infer
from segmentation3d_tpu_torch.cli.seg_train import main as seg_train
from segmentation3d_tpu_torch.core import folds
from segmentation3d_tpu_torch.core.seg_train import _prepare_save_dir, train
from segmentation3d_tpu_torch.core.validation import validate_cases
from segmentation3d_tpu_torch.utils import model_io
from segmentation3d_tpu_torch.utils.normalizer import AdaptiveNormalizer
from test_torch_port_checkpoint import KW, seeded_variables

#: a two-level net keeps JAX's op-by-op flax init (a compile per op) short
NET_KW = dict(base_channels=4, down_convs=(1, 1), up_convs=(1, 1))
NET = "".join(f"__C.net.{k} = {v!r}\n" for k, v in NET_KW.items())


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    d = str(root / "data")
    cases = [make_sphere_case(d, f"c{i}", shape_zyx=(24, 26, 22),
                              spacing=(1.1, 0.9, 1.2), seed=i) for i in range(3)]
    cases.append(make_sphere_case(d, "big", shape_zyx=(40, 30, 28), seed=3))
    return root, cases


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_validate_cases_matches_jax(data):
    root, cases = data
    val = make_train_list(str(root / "val.txt"), [cases[2], cases[3]])
    v, net = seeded_variables(seed=11)
    jnet = JaxNet(in_channels=1, out_channels=2, **KW)
    kw = dict(spacing=[1.0, 1.0, 1.0], interpolation="LINEAR", num_classes=2,
              max_stride=4, shape_bucket=16, size_cap=24, slab_z=16,
              slab_overlap=4)
    want = jax_validate(jnet, v, val, normalizers=[JaxAdaptive()], **kw)
    net.train()
    got = validate_cases(net, val, normalizers=[AdaptiveNormalizer()], **kw)
    assert net.training  # back in train mode
    assert got[2] == want[2] == 2
    np.testing.assert_allclose(got[1], want[1], atol=1e-3)
    assert got[0] == pytest.approx(want[0], abs=1e-3)
    assert 0.0 < got[0] < 1.0


def _config(root, name, cases, val, extra="", **kw):
    lst = make_train_list(str(root / f"{name}_train.txt"), cases)
    args = dict(crop_size=(16, 16, 16), epochs=4, batchsize=2, lr=1e-3,
                save_epochs=2, sampling_method="MASK")
    args.update(kw)
    return write_train_config(
        str(root / f"{name}.py"), lst, str(root / name), **args,
        extra=NET + (f"__C.train.val_list = r'{val}'\n" if val else "") + extra)


@pytest.fixture(scope="module")
def trained(data):
    """JAX's train and the port's seg_train on one config, both resumed
    from one JAX-written chk_0."""
    root, cases = data
    val = make_train_list(str(root / "val2.txt"), [cases[2]])
    v, _ = seeded_variables(seed=12, kw=NET_KW)
    out = {}
    for pkg in ("jax", "port"):
        cfg = _config(root, f"run_{pkg}", cases[:2], val,
                      extra="__C.dataset.random_flip = True\n"
                            "__C.train.save_best = True\n")
        text = open(cfg).read().replace("__C.general.resume_epoch = -1",
                                        "__C.general.resume_epoch = 0")
        open(cfg, "w").write(text)
        jax_io.save_checkpoint(str(root / f"run_{pkg}"), 0, -1, v, "vnet", 16,
                               1, 2, [1.0, 1.0, 1.0], "LINEAR",
                               [JaxAdaptive(0.001, 0.999, True)],
                               extra={"net_kwargs": dict(NET_KW)})
        if pkg == "jax":
            jax_train(cfg)
        else:
            seg_train(["-i", cfg, "-g", "-1"])
        out[pkg] = str(root / f"run_{pkg}")
    return root, cases, out


def test_seg_train_matches_jax_train(trained):
    _, _, out = trained
    jrows, prows = (_rows(os.path.join(out[p], "train_loss.csv"))
                    for p in ("jax", "port"))
    assert prows[0] == jrows[0] == ["epoch", "batch", "loss"]
    assert len(prows) == len(jrows) == 5
    for j, p in zip(jrows[1:4], prows[1:4]):
        assert p[:2] == j[:2]
        assert float(p[2]) == pytest.approx(float(j[2]), rel=1e-3)
    jval, pval = (_rows(os.path.join(out[p], "val_dice.csv")) for p in ("jax", "port"))
    assert pval[0] == jval[0] and [r[0] for r in pval] == [r[0] for r in jval]

    def listing(root):
        files = set()
        for dirpath, _, names in os.walk(root):
            rel = os.path.relpath(dirpath, root)
            files |= {os.path.join(rel, n).replace("opt_state.pkl", "opt_state.pt")
                      .replace(os.path.basename(root) + ".py", "config copy")
                      for n in names}
        return files
    assert listing(out["port"]) == listing(out["jax"])
    assert os.path.isfile(os.path.join(out["port"], "checkpoints", "chk_4",
                                       "run_port.py"))


def test_port_checkpoint_loads_in_jax(trained):
    root, cases, out = trained
    chk = os.path.join(out["port"], "checkpoints", "chk_4")
    variables, payload = jax_io.load_checkpoint(chk)
    assert payload["net"] == "vnet" and payload["epoch_idx"] == 4
    assert jax_io.load_opt_state(chk) is None  # the port's optimizer state is its own
    jnet = JaxNet(in_channels=1, out_channels=2, **payload["net_kwargs"])
    x = np.random.default_rng(0).normal(size=(1, 16, 16, 16, 1)).astype(np.float32)
    want = np.asarray(jnet.apply(variables, jnp.asarray(x), train=False))
    from segmentation3d_tpu_torch.core.seg_infer import load_seg_model
    model = load_seg_model(out["port"], torch.device("cpu"))
    with torch.no_grad():
        got = model.net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    # and through JAX's inference entry against the port's seg_infer
    m = jax_load_seg_model(out["port"], checkpoint="best")
    assert m.epoch_idx in (2, 4)
    img = cases[2][0][0]
    jax_segmentation(img, out["port"], str(root / "jax_mask"), checkpoint="best")
    seg_infer(["-i", img, "-m", out["port"], "-o", str(root / "port_mask"),
               "-g", "-1", "--checkpoint", "best"])
    a = jax_read(str(root / "jax_mask" / "c2_mod0" / "seg.mha")).data
    b = jax_read(str(root / "port_mask" / "c2_mod0" / "seg.mha")).data
    assert a.shape == b.shape and np.mean(a == b) >= 0.98


def test_resume_equals_uninterrupted(data):
    root, cases = data
    extra = ("__C.dataset.random_translation = [0.0, 0.0, 0.0]\n"
             "__C.train.lr_scheduler = {'name': 'cosine'}\n")
    cfg = _config(root, "full", cases[:1], None, extra=extra, batchsize=1,
                  sampling_method="CENTER")
    train(cfg, device="cpu")
    part = str(root / "part")
    shutil.copytree(str(root / "full"), part)
    shutil.rmtree(os.path.join(part, "checkpoints", "chk_4"))
    text = open(cfg).read().replace(
        f'save_dir = r"{root / "full"}"', f'save_dir = r"{part}"').replace(
        "__C.general.resume_epoch = -1", "__C.general.resume_epoch = 2")
    resume_cfg = str(root / "part.py")
    open(resume_cfg, "w").write(text)
    train(resume_cfg, device="cpu")
    a = model_io.load_checkpoint_payload(os.path.join(root, "full", "checkpoints", "chk_4"))
    b = model_io.load_checkpoint_payload(os.path.join(part, "checkpoints", "chk_4"))
    for k, t in a["state_dict"].items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(b["state_dict"][k].numpy(), t.numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    oa, ob = (model_io.load_opt_state(os.path.join(r, "checkpoints", "chk_4"))
              for r in (os.path.join(root, "full"), part))
    assert oa["step"] == ob["step"] == 4


def test_save_dir_wipe_and_refuse(tmp_path):
    d = tmp_path / "model"
    d.mkdir()
    (d / "train_loss.csv").write_text("x")
    (d / "checkpoints").mkdir()
    _prepare_save_dir(str(d), resume=False)  # a run's own files: wiped
    assert os.listdir(d) == []
    (d / "train_loss.csv").write_text("x")
    _prepare_save_dir(str(d), resume=True)  # resume keeps them
    assert os.listdir(d) == ["train_loss.csv"]
    (d / "NOTES.txt").write_text("precious")
    with pytest.raises(RuntimeError, match="refusing to wipe"):
        _prepare_save_dir(str(d), resume=False)
    assert (d / "NOTES.txt").exists()


@pytest.mark.parametrize("n,k,seed", [(5, 2, 0), (7, 3, 4), (3, 3, 1)])
def test_fold_split_is_jaxs(n, k, seed):
    assert folds.split_folds(n, k, seed) == jax_folds.split_folds(n, k, seed)


def test_folds_cli(data, capsys):
    root, cases = data
    cfg = _config(root, "cv", cases[:3], None, epochs=1, save_epochs=1,
                  batchsize=1)
    with pytest.raises(SystemExit):
        seg_train(["-i", cfg, "--fold", "0", "-g", "-1"])
    assert "--fold requires --folds" in capsys.readouterr().err
    with pytest.raises(ValueError, match="out of range"):
        seg_train(["-i", cfg, "--folds", "3", "--fold", "3", "-g", "-1"])
    with pytest.raises(ValueError, match="must be >= 2"):
        seg_train(["-i", cfg, "--folds", "1", "-g", "-1"])
    seg_train(["-i", cfg, "--folds", "3", "--fold", "1", "-g", "-1"])
    setup = str(root / "cv_fold1.setup")
    port_lists = [open(os.path.join(setup, f)).read() for f in ("train.txt", "val.txt")]
    shutil.rmtree(setup)
    jax_folds.prepare_fold(cfg, 3, 1)
    assert [open(os.path.join(setup, f)).read()
            for f in ("train.txt", "val.txt")] == port_lists
    rows = _rows(str(root / "cv_fold1" / "val_dice.csv"))
    assert rows[0][:2] == ["epoch", "val_dice"] and len(rows) == 2


def test_train_refuses_silent_cpu(data):
    """Without a CUDA device and without -g -1 the trainer raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    root, cases = data
    cfg = _config(root, "nocuda", cases[:1], None)
    with pytest.raises(RuntimeError, match="CUDA"):
        seg_train(["-i", cfg])
    assert not os.path.exists(root / "nocuda")


@pytest.mark.parametrize("extra,match", [
    # JAX's order: the mesh first (one device here), then its rules
    ("__C.tpu = edict()\n__C.tpu.mesh = edict()\n__C.tpu.mesh.spatial = 2\n",
     "1 device\\(s\\) do not divide over a spatial mesh axis of 2"),
    ("__C.tpu = edict()\n__C.tpu.conv_backend = 'packed_domian'\n", "conv_backend"),
    ("__C.tpu = edict()\n__C.tpu.conv_backend = 'packed_domain'\n", "in_block packing"),
    ("__C.tpu = edict()\n__C.tpu.steps_per_dispatch = 2\n"
     "__C.train.grad_accum_steps = 2\n", "cannot be combined"),
    ("__C.train.grad_accum_steps = 3\n", "must divide"),
    ("__C.train.save_best = True\n", "save_best requires"),
])
def test_config_rules(data, extra, match):
    root, cases = data
    cfg = _config(root, "rules", cases[:1], None, extra=extra)
    with pytest.raises(ValueError, match=match):
        train(cfg, device="cpu")


def test_more_devices_than_there_are_train_on_one(data):
    """mesh.data = 2 (and num_gpus = 4) on the CPU, one device: the mesh is
    clamped to it, as make_mesh clamps, and the run trains."""
    root, cases = data
    cfg = _config(root, "clamped", cases[:1], None, epochs=1, save_epochs=1,
                  batchsize=1, extra="__C.general.num_gpus = 4\n__C.tpu = edict()\n"
                                     "__C.tpu.mesh = edict()\n__C.tpu.mesh.data = 2\n")
    train(cfg, device="cpu")
    log = open(root / "clamped" / "train_log.txt").read()
    assert "1 device(s) (data 1 x spatial 1), rank 0 on cpu" in log
    assert "training group" not in log
    assert os.path.isdir(root / "clamped" / "checkpoints" / "chk_1")


def test_validation_fold_rules(data, monkeypatch):
    """The folded route (forced on the CPU through ``build_forward``'s
    ``fused=True``, where thin_conv3d runs its plain version): re-folded
    from the live weights at every save point; a net with no folded form
    (leaky_relu) runs the module and no fold is tried; a fold that fails
    propagates, at the first save point as at a later one."""
    import segmentation3d_tpu_torch.models.fused_vnet as fused
    from segmentation3d_tpu_torch.core import seg_infer
    root, cases = data
    val = make_train_list(str(root / "val_fold.txt"), [cases[2]])
    kw = dict(spacing=[1.0, 1.0, 1.0], interpolation="LINEAR", num_classes=2,
              max_stride=4, normalizers=[AdaptiveNormalizer()],
              dtype=torch.bfloat16)
    build = seg_infer.build_forward
    monkeypatch.setattr(seg_infer, "build_forward",
                        lambda net, dtype, device: build(net, dtype, device, fused=True))
    folds_built = []
    real = fused.build_fused_forward

    def spy(net, dtype=torch.bfloat16, stats=False):
        folds_built.append(net.act)
        return real(net, dtype=dtype, stats=stats)
    monkeypatch.setattr(fused, "build_fused_forward", spy)
    _, relu_net = seeded_variables(seed=13)
    cache = {}
    first = validate_cases(relu_net, val, inferer_cache=cache, **kw)
    with torch.no_grad():
        relu_net.out_block.proj.bias.add_(torch.tensor([5.0, -5.0]))
    second = validate_cases(relu_net, val, inferer_cache=cache, **kw)
    assert folds_built == ["relu", "relu"]
    assert second[0] != first[0]  # the second save point scored the new weights
    _, leaky = seeded_variables("leaky_relu", seed=13)
    lcache = {}
    validate_cases(leaky, val, inferer_cache=lcache, **kw)
    validate_cases(leaky, val, inferer_cache=lcache, **kw)
    assert folds_built == ["relu", "relu"]  # the leaky_relu net never folds

    def broken(*a, **k):
        raise NotImplementedError("fold broke")
    monkeypatch.setattr(fused, "build_fused_forward", broken)
    for at in (cache, {}):  # a later save point, then a run's first
        with pytest.raises(NotImplementedError, match="fold broke"):
            validate_cases(relu_net, val, inferer_cache=at, **kw)


def test_validation_folds_a_vbnet(data, monkeypatch):
    """A vbnet validates through ``build_forward``'s fold (forced on the
    CPU, as above): the fold is built from the bottleneck net, and its
    mean Dice is within 0.02 of the float32 module's."""
    import segmentation3d_tpu_torch.models.fused_vnet as fused
    from segmentation3d_tpu_torch.core import seg_infer
    root, cases = data
    val = make_train_list(str(root / "val_vbnet.txt"), [cases[2]])
    kw = dict(spacing=[1.0, 1.0, 1.0], interpolation="LINEAR", num_classes=2,
              max_stride=4, normalizers=[AdaptiveNormalizer()])
    _, vbnet = seeded_variables(seed=14, kw=dict(KW, bottleneck=True))
    module = validate_cases(vbnet, val, dtype=torch.float32, **kw)
    build = seg_infer.build_forward
    monkeypatch.setattr(seg_infer, "build_forward",
                        lambda net, dtype, device: build(net, dtype, device, fused=True))
    folds_built = []
    real = fused.build_fused_forward

    def spy(net, dtype=torch.bfloat16, stats=False):
        folds_built.append(net.bottleneck)
        return real(net, dtype=dtype, stats=stats)
    monkeypatch.setattr(fused, "build_fused_forward", spy)
    folded = validate_cases(vbnet, val, dtype=torch.bfloat16, **kw)
    assert folds_built == [True]
    assert folded[2] == module[2] == 1
    assert abs(folded[0] - module[0]) < 0.02
