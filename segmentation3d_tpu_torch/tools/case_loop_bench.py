"""Time ``seg_infer --bf16`` over one folder of CT cases with two checkouts
of the port in turns (``a b b a ...``), on one GPU.

The folder is ``chip_smoke.py``'s: its seeded 512x512x240 int16 CT case, a
second seed and a 512x512x160 case, with its seeded full-width V-Net (BN
statistics and head fitted to the phantom), 96^3 boxes at stride 64. Each
turn is a fresh process of one checkout that runs the folder twice and
reports both batches (the second is warm: kernels built and loaded, cuDNN
initialised); it prints one JSON line per turn, then a summary line with
each checkout's median warm wall time and volumes/min. Compare two versions
only within one run of this script.

    python -m segmentation3d_tpu_torch.tools.case_loop_bench --other DIR [--rounds 2]

``DIR`` is another checkout of the repository (e.g. a ``git archive`` of a
parent commit); this one is ``b``, the other ``a``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# runs in a fresh process of one checkout: the folder twice, timed in-process
CHILD = r"""
import json, sys, time
import torch
from segmentation3d_tpu_torch.cli.seg_infer import main
argv, out = json.loads(sys.argv[1]), sys.argv[2]
batches = []
for i in range(2):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    res = main(argv + ["-o", f"{out}_{i}"])
    torch.cuda.synchronize()
    batches.append(dict(wall=time.perf_counter() - t,
                        cases=[dict(name=r[0], seconds=r[1], stages=r[2]) for r in res],
                        max_memory_allocated=torch.cuda.max_memory_allocated()))
print("RESULT " + json.dumps(batches))
"""


def make_folder(workdir):
    """The folder of three cases and the model, from ``chip_smoke.py``'s
    seeded phantom and net; returns the ``seg_infer`` arguments."""
    import torch
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from segmentation3d_tpu_torch.utils.model_io import save_checkpoint
    from segmentation3d_tpu_torch.utils.normalizer import FixedNormalizer
    norm = FixedNormalizer(40.0, 400.0, True)
    net = cs.calibrate(torch, cs.seeded_vnet(torch), norm)
    model = os.path.join(workdir, "model")
    save_checkpoint(model, 1, 0, net.state_dict(), "vnet", 16, 1, 2,
                    [1.0, 1.0, 1.0], "LINEAR", [norm])
    folder = os.path.join(workdir, "in")
    os.makedirs(folder)
    cs.make_ct(os.path.join(folder, "a_main.nii.gz"))
    cs.make_ct(os.path.join(folder, "b_seed1.nii.gz"), seed=1)
    cs.make_ct(os.path.join(folder, "c_short.nii.gz"), seed=2, slices=160)
    return ["-i", folder, "-m", model, "--bf16", "--partition_type", "SIZE",
            "--partition_size", "96", "96", "96",
            "--partition_stride", "64", "64", "64"]


def turn(checkout, argv, out):
    """One fresh process of ``checkout`` over the folder, twice."""
    env = dict(os.environ, PYTHONPATH=checkout)
    proc = subprocess.run([sys.executable, "-c", CHILD, json.dumps(argv), out],
                          cwd=checkout, env=env, capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{checkout} failed:\n{proc.stderr[-4000:]}")
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", required=True, help="another checkout (a)")
    parser.add_argument("--rounds", type=int, default=2,
                        help="rounds of a b b a")
    args = parser.parse_args(argv)
    checkouts = {"a": os.path.abspath(args.other), "b": HERE}
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0]
    warm = {"a": [], "b": []}
    with tempfile.TemporaryDirectory() as workdir:
        seg_argv = make_folder(workdir)
        order = ["a", "b", "b", "a"] * args.rounds
        for i, tag in enumerate(order):
            out = os.path.join(workdir, f"out{i}")
            batches = turn(checkouts[tag], seg_argv, out)
            warm[tag].append(batches[1]["wall"])
            print(json.dumps({"turn": i, "checkout": tag, "path": checkouts[tag],
                              "batches": batches, "cpu_count": os.cpu_count(),
                              "gpu": gpu}), flush=True)
            for j in range(2):
                shutil.rmtree(f"{out}_{j}", ignore_errors=True)
    n = 3  # cases in the folder
    print(json.dumps({"summary": {
        tag: dict(warm_walls=w, median_wall=statistics.median(w),
                  volumes_per_min=60.0 * n / statistics.median(w))
        for tag, w in warm.items()}, "gpu": gpu}))


if __name__ == "__main__":
    main()
