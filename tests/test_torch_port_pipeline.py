"""The pipelined case loop (read-ahead and write-behind threads) against the
JAX package's segmentation() on the CPU: a folder of three phantom cases of
different shapes plus one corrupt file, float32, the same base-4 weights.

The masks must be identical, or agree on >= 99.9% of voxels with every
differing voxel an argmax near-tie (|p0 - p1| < 1e-4 in JAX's probability
maps, plus their float16 storage step); the probability maps within 2e-3.
"""
import os
import shutil
import threading

import numpy as np
import pytest
import torch

from phantoms import make_sphere_case
from segmentation3d_tpu.core.seg_infer import segmentation as jax_segmentation
from segmentation3d_tpu.io import read_image as jax_read
from segmentation3d_tpu.utils import model_io as jax_io
from segmentation3d_tpu.utils.normalizer import AdaptiveNormalizer
from segmentation3d_tpu_torch.core import seg_infer
from segmentation3d_tpu_torch.core.seg_infer import prepare_cases, segmentation
from test_torch_port_checkpoint import KW, seeded_variables

CASES = {"case0_mod0": (30, 34, 28), "case1_mod0": (26, 30, 32),
         "case2_mod0": (34, 28, 30)}
STAGES = {"read", "prep", "forward", "back", "write"}


def save_model(path, seed, kw=KW, net="vnet", spacing=(1.0, 1.0, 1.0)):
    """A JAX-written checkpoint of ``seeded_variables(seed=seed)``."""
    v, _ = seeded_variables(seed=seed, kw=kw)
    jax_io.save_checkpoint(str(path), 1, 0, v, net, 4, 1, 2, list(spacing),
                           "LINEAR", [AdaptiveNormalizer()],
                           extra={"net_kwargs": dict(kw)})
    return str(path)


def assert_same_mask(got_dir, ref_dir, name="case_mod0", both_labels=True):
    """The port's seg.mha under ``got_dir/name`` against JAX's under
    ``ref_dir/name`` by the rule of this file's docstring, and both
    probability maps within 2e-3 when JAX wrote them. ``both_labels``:
    JAX's mask must hold both labels, so that the comparison has teeth."""
    def out(root, f):
        return jax_read(os.path.join(root, name, f)).data
    ref, got = out(ref_dir, "seg.mha"), out(got_dir, "seg.mha")
    assert got.shape == ref.shape and got.dtype == np.uint8
    if both_labels:
        assert 0.02 < np.mean(ref == 1) < 0.98
    differ = got != ref
    assert differ.mean() <= 1e-3
    if not os.path.exists(os.path.join(ref_dir, name, "prob_0.mha")):
        assert not differ.any()
        return
    p0, p1 = (out(ref_dir, f"prob_{c}.mha") for c in (0, 1))
    assert np.all(np.abs(p0 - p1)[differ] < 1e-4 + 2.0 ** -11)
    if os.path.exists(os.path.join(got_dir, name, "prob_0.mha")):
        for c in (0, 1):
            np.testing.assert_allclose(out(got_dir, f"prob_{c}.mha"),
                                       out(ref_dir, f"prob_{c}.mha"), atol=2e-3)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipeline")
    inp = d / "in"
    inp.mkdir()
    for i, (name, shape) in enumerate(CASES.items()):
        imgs, _ = make_sphere_case(str(d / "src"), name[:5], shape_zyx=shape,
                                   spacing=(1.1, 0.9, 1.3), seed=i)
        shutil.copy(imgs[0], inp / os.path.basename(imgs[0]))
    (inp / "broken.nii.gz").write_bytes(b"not a nifti file")
    model = save_model(d / "model", seed=4)
    jax_segmentation(str(inp), model, str(d / "jax"), save_prob=True)
    return d, str(inp), model


def test_folder_matches_jax(folder, capsys):
    d, inp, model = folder
    res = segmentation(inp, model, str(d / "port"), device="cpu", save_prob=True)
    assert [r[0] for r in res] == list(CASES)
    for name, seconds, stages in res:
        assert set(stages) == STAGES and seconds >= stages["write"] > 0
        assert_same_mask(str(d / "port"), str(d / "jax"), name)
    out = capsys.readouterr().out
    assert "ERROR: skipping broken" in out  # reported, not fatal
    assert not os.path.exists(d / "port" / "broken")
    for name in CASES:
        assert f"segmentation of {name}: " in out


def test_writer_failure_is_surfaced(folder, monkeypatch, capsys):
    """A write that fails is reported and takes its case out of the
    results; the other cases are still written."""
    d, inp, model = folder
    real = seg_infer.write_image

    def flaky(vol, path):
        if "case1" in path:
            raise OSError("disk full")
        real(vol, path)
    monkeypatch.setattr(seg_infer, "write_image", flaky)
    res = segmentation(inp, model, str(d / "flaky"), device="cpu")
    assert [r[0] for r in res] == ["case0_mod0", "case2_mod0"]
    assert "ERROR: writing results of case1_mod0 failed: disk full" in \
        capsys.readouterr().out
    for name in ("case0_mod0", "case2_mod0"):
        assert_same_mask(str(d / "flaky"), str(d / "jax"), name)


def test_prepared_input(folder):
    d, inp, model = folder
    prepared = prepare_cases(inp, device="cpu")
    res = segmentation(inp, model, str(d / "prep"), device="cpu",
                       prepared=prepared)
    assert [r[0] for r in res] == list(CASES)
    for name in CASES:
        assert_same_mask(str(d / "prep"), str(d / "jax"), name)
    other = prepare_cases(os.path.join(inp, "case0_mod0.nii.gz"), device="cpu")
    with pytest.raises(ValueError, match="prepared input"):
        segmentation(inp, model, str(d / "prep_bad"), device="cpu",
                     prepared=other)
    other.reader.close()


def test_abort_mid_list_still_writes_pending_cases(folder, monkeypatch):
    """An interrupt in the middle of the list propagates, the case already
    handed to the writer is still written, and every reader and writer
    thread ends."""
    d, inp, model = folder
    real = seg_infer.segmentation_one_case
    calls = []

    def interrupt_second(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise KeyboardInterrupt
        return real(*a, **k)
    monkeypatch.setattr(seg_infer, "segmentation_one_case", interrupt_second)
    before = threading.active_count()
    with pytest.raises(KeyboardInterrupt):
        segmentation(inp, model, str(d / "abort"), device="cpu")
    assert_same_mask(str(d / "abort"), str(d / "jax"), "case0_mod0")
    assert not os.path.exists(d / "abort" / "case1_mod0")
    assert threading.active_count() == before


class _ThreadDeath(BaseException):
    """Escapes the read-ahead's per-case handling and ends its thread."""


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_a_dying_reader_thread_surfaces_its_error(folder, monkeypatch):
    """A read-ahead thread that dies raises its error in the loop instead of
    ending the list early; the case already handed on is still written."""
    d, inp, model = folder
    real = seg_infer._upload
    calls = []

    def die_on_second(data, device):
        calls.append(1)
        if len(calls) == 2:
            raise _ThreadDeath
        return real(data, device)
    monkeypatch.setattr(seg_infer, "_upload", die_on_second)
    with pytest.raises(_ThreadDeath):
        segmentation(inp, model, str(d / "dying"), device="cpu")
    assert_same_mask(str(d / "dying"), str(d / "jax"), "case0_mod0")
    assert not os.path.exists(d / "dying" / "case1_mod0")


def test_every_case_failing_raises(tmp_path):
    """With no case left, the first case's error is raised, as in JAX."""
    (tmp_path / "in").mkdir()
    (tmp_path / "in" / "bad.nii.gz").write_bytes(b"not a nifti file")
    model = save_model(tmp_path / "model", seed=4)
    with pytest.raises(Exception) as ref:
        jax_segmentation(str(tmp_path / "in"), model, str(tmp_path / "jax"))
    with pytest.raises(type(ref.value), match="decompress"):
        segmentation(str(tmp_path / "in"), model, str(tmp_path / "out"),
                     device="cpu")


def test_upload_keeps_the_stored_dtype():
    """CT's int16 crosses as int16 (cast to float32 on the device), any
    byte order; a type torch lacks crosses as float32."""
    cpu = torch.device("cpu")
    a = np.arange(-6, 6, dtype=np.int16).reshape(2, 2, 3)
    for arr in (a, a.astype(">i2")):
        t = seg_infer._upload(arr, cpu)
        assert t.dtype == torch.int16
        np.testing.assert_array_equal(t.numpy(), a)
    t = seg_infer._upload(a.astype(np.uint16), cpu)
    assert t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), a.astype(np.uint16))
