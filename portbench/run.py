"""The benchmark of ``segmentation3d_tpu_torch`` on NVIDIA GPUs.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the card it is started on: makes the
cell's inputs and weights from the seed, warms up every shape the cell
uses (set-up), measures for ``--seconds`` (with ``--trace 1`` under the
profiler, reporting the per-layer metrics instead of the end-to-end ones),
then holds what the timed path wrote against the plain float32 reference
(``portbench/reference/``). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` a ``breakdown``, and last ``checks``, each compared
number beside its limit; the same numbers are the last lines of standard
error. Exits nonzero with no result when there is no CUDA device, when the
cell asks for more devices than there are, or when JAX or the JAX package
was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# run as a script, this folder heads sys.path: the checkout's root takes its
# place, so that the harness's modules are imported as ``portbench.*`` only
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") not in (HERE, ROOT)]

from portbench.manifest import Cell, load  # noqa: E402

#: top-level module names that may not be loaded in a run
BANNED = ("jax", "jaxlib", "flax", "optax", "segmentation3d_tpu")


def leaked_modules(modules=None):
    """The banned top-level names among ``sys.modules``, compared whole."""
    names = {m.split(".", 1)[0] for m in (modules if modules is not None else sys.modules)}
    return sorted(names & set(BANNED))


class Context:
    """What a driver gets: the cell's files, the run's arguments, a scratch
    directory under ``TMPDIR`` and the device."""

    def __init__(self, cell, seed, seconds, trace, tmp, device="cuda:0"):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.cfg, self.traffic, self.limits = cell.config, cell.traffic, cell.limits
        self.tmp, self.device, self.t_start = tmp, device, T_START


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(cell, run, trace):
    """The result object of a finished run (``run``: a driver's result)."""
    import torch
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = cell.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": run["e2e"][m["name"]], "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.entry["chips"], "memory_peak_bytes": run["memory_peak_bytes"]}
    out = {"correct": run["correct"], "attempted": run["attempted"],
           "failed": run["failed"], "metrics": metrics, "device": device}
    tr = run.get("trace")
    if trace and tr is not None:
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in run["checks"]}
    return out


def main(argv=None):
    args = parse(argv)
    cell = Cell(load(), args.workload)
    import torch
    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.entry["chips"]:
        print(f"portbench: {cell.name} needs {cell.entry['chips']} devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        driver = importlib.import_module(f"portbench.drivers.{cell.traffic['kind']}")
        run = driver.run(Context(cell, args.seed, args.seconds, bool(args.trace), tmp))
        leaked = leaked_modules()
        if leaked:
            print(f"portbench: loaded in this process: {', '.join(leaked)}", file=sys.stderr)
            return 4
        out = result_line(cell, run, args.trace)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name, v in out["checks"].items():
        print(f"check {name}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
