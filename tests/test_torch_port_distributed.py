"""Several processes: round-robin case slicing, the single-process
degradation of parallel.distributed, and one two-process run of the
seg_infer CLI over a gloo group on the CPU (torchrun's environment set by
hand), which must write exactly the files of a one-process run."""
import os
import socket
import subprocess
import sys

import numpy as np

import segmentation3d_tpu.core.seg_infer as jsi
from segmentation3d_tpu_torch.cli.seg_infer import main as seg_infer
from segmentation3d_tpu_torch.core import seg_infer as si
from segmentation3d_tpu_torch.io import Volume, read_image, write_image
from segmentation3d_tpu_torch.ops.geometry import Frame
from segmentation3d_tpu_torch.parallel import distributed
from test_torch_port_serve import _tiny_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_process_slice_round_robin():
    """tests/test_distributed.py's cases, against the JAX function too."""
    cases = [f"c{i}" for i in range(7)]
    assert si._process_slice(cases) == cases  # single-process identity
    s0 = si._process_slice(cases, 0, 2)
    s1 = si._process_slice(cases, 1, 2)
    assert s0 == ["c0", "c2", "c4", "c6"] and s1 == ["c1", "c3", "c5"]
    parts = [si._process_slice(cases, i, 3) for i in range(3)]
    assert sorted(sum(parts, [])) == cases
    assert max(len(p) for p in parts) - min(len(p) for p in parts) <= 1
    for pc in (1, 2, 3, 8):
        for pi in range(pc):
            assert si._process_slice(cases, pi, pc) == jsi._process_slice(cases, pi, pc)


def test_single_process_degrades_to_identity(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert distributed.initialize() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert distributed.initialize() is False
    assert (distributed.process_index(), distributed.process_count()) == (0, 1)
    assert distributed.is_primary()
    distributed.barrier("noop")
    obj = {"order": [3, 1, 2]}
    assert distributed.broadcast_from_primary(obj) is obj
    distributed.shutdown()  # no group: nothing to end


def test_empty_slice_prints_jax_note(monkeypatch, tmp_path, capsys):
    """More processes than cases: the process with none says so in JAX's
    words, and returns no results."""
    import jax
    monkeypatch.setattr(jax, "process_index", lambda: 2)
    monkeypatch.setattr(jax, "process_count", lambda: 3)
    jsi._announce_no_cases(2, "in")
    ref = capsys.readouterr().out
    monkeypatch.setattr(distributed, "process_index", lambda: 2)
    monkeypatch.setattr(distributed, "process_count", lambda: 3)
    model_dir = _tiny_model(str(tmp_path / "model"))
    for name in ("a", "b"):
        write_image(Volume(np.zeros((8, 8, 8), np.float32), Frame.identity()),
                    str(tmp_path / "in" / f"{name}.nii.gz"))
    assert si.segmentation(str(tmp_path / "in"), model_dir, str(tmp_path / "out"),
                           device="cpu") == []
    assert capsys.readouterr().out == ref == \
        "note: empty case slice on process 2/3 (2 case(s) assigned to other processes)\n"


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_two_processes_write_the_one_process_files(tmp_path):
    """Two seg_infer processes in one gloo group over four cases, two of
    which share a file name and a parent directory name: together they
    write exactly the one-process run's files (names made unique over the
    whole list, tests/test_c2f_parity.py's case), each case once."""
    model_dir = _tiny_model(str(tmp_path / "model"))
    paths = [tmp_path / "a" / "s" / "image.nii.gz", tmp_path / "b" / "s" / "image.nii.gz",
             tmp_path / "c.nii.gz", tmp_path / "d.nii.gz"]
    rng = np.random.default_rng(0)
    for p in paths:
        write_image(Volume(rng.normal(0, 1, (16, 16, 16)).astype(np.float32),
                           Frame.identity()), str(p))
    listing = tmp_path / "cases.txt"
    listing.write_text("4\n" + "".join(f"{p}\n" for p in paths))
    argv = ["-i", str(listing), "-m", model_dir, "-g", "-1", "--batch_size", "2"]

    seg_infer(argv + ["-o", str(tmp_path / "one")])
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "segmentation3d_tpu_torch.cli.seg_infer"]
            + argv + ["-o", str(tmp_path / "two")], env=env, cwd=str(tmp_path),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    # rank 0 took cases 0 and 2, rank 1 cases 1 and 3
    assert "of s/image:" in outs[0] and "of c:" in outs[0]
    assert "of s/image_2:" in outs[1] and "of d:" in outs[1]
    one, two = _files(str(tmp_path / "one")), _files(str(tmp_path / "two"))
    assert one == two == ["c/seg.mha", "d/seg.mha", "s/image/seg.mha",
                          "s/image_2/seg.mha"]
    for f in one:
        np.testing.assert_array_equal(read_image(str(tmp_path / "two" / f)).data,
                                      read_image(str(tmp_path / "one" / f)).data)
