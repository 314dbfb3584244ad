"""A cell of the manifest cut to a size that the CPU runs in seconds: the
same files, with the net's widths, the pool and the boxes made small."""
import copy
import tempfile

from portbench.manifest import Cell, load
from portbench.run import Context

TINY_POOL = {"xy": 48, "slices": [24, 32], "spacing_xyz": [0.7, 0.7, 1.25]}
TINY_TRAIN_POOL = {"xy": 96, "slices": [40, 48, 56, 64], "spacing_xyz": [0.7, 0.7, 1.25]}


def tiny_context(name, tmp, seed=2 ** 31 + 5, seconds=1.0, **traffic):
    cell = copy.deepcopy(Cell(load(), name))
    cell.config["net"]["base_channels"] = 4
    cell.config["crop"] = [32, 32, 32]
    tr = cell.traffic
    if tr["kind"] == "train":
        tr.update(pool=TINY_TRAIN_POOL, warm_steps=2, trace_steps=4)
    else:
        tr.update(pool=TINY_POOL, patch=[32, 32, 32], stride=[16, 16, 16],
                  check_masks=3, trace_cases=2, trace_seconds=1, max_requests=12)
    tr.update(traffic)
    return Context(cell, seed, seconds, False, tempfile.mkdtemp(dir=tmp), device="cpu")
