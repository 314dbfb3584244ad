"""The controls fail the cells' limits (needs a CUDA device).

At a size a test run holds: each cell's set-up with a smaller pool (and,
for training, three steps), the program as the cell runs it against the
cell's limits (within them), and the cell's control (the program's int8
path, or the reference in fp8) and the half-batch fault (outside them).
On the card: ``python -m pytest -m cuda portbench/tests``."""
import copy
import tempfile

import pytest
import torch

from portbench import control
from portbench.drivers import common
from portbench.manifest import Cell, load
from portbench.run import Context

SMALL_POOL = {"xy": 256, "slices": [96, 128, 160, 192], "spacing_xyz": [0.7, 0.7, 1.25]}


def _context(name, tmp):
    cell = copy.deepcopy(Cell(load(), name))
    cell.traffic["pool"] = SMALL_POOL
    return Context(cell, 2 ** 31 + 17, 0.0, False, tempfile.mkdtemp(dir=tmp))


def _fails(nums, limits):
    return any(nums[k] > limits[k] for k in limits["compared"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["vnet.infer_bf16", "vbnet.infer_bf16", "vnet.train_bf16"])
def test_the_control_fails_the_limits(tmp_path, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the controls run at the cells' widths")
    ctx = _context(name, tmp_path)
    lim = ctx.limits
    if ctx.traffic["kind"] == "train":
        out = control.train_readings(ctx)
        assert _fails(out["fault_half_batch"], lim), out["fault_half_batch"]
    else:
        out = control.infer_readings(ctx, common.Inputs(ctx), lim["control"])
    assert not _fails(out["program"], lim), out["program"]
    names = ["reference_" + k for k in lim["control"].get("reference", ())]
    if "quant" in lim["control"]:
        names.append("program_" + lim["control"]["quant"])
    for name in names:
        assert _fails(out[name], lim), (name, out[name])
