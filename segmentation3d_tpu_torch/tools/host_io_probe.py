"""Time the host steps of one case around the device, on one GPU: the read
(gunzip + parse) on the calling thread and on another, the upload as the read-ahead does it (pinned buffer, copy
into it, host-to-device copy) and as a pageable copy, and the write of the
mask from a pinned buffer, from a fresh pageable ``.cpu()`` copy (timing
the write alone) and from a numpy array. Each step runs ``--reps`` times in
one process; prints one JSON line per step (seconds of every repetition)
with the card's name and power limit.

    python -m segmentation3d_tpu_torch.tools.host_io_probe [--reps 4]

The case is ``chip_smoke.py``'s seeded 512x512x240 int16 CT volume.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timed(fn, reps):
    """Seconds of each call of ``fn``, or what it returns if that is a
    number (its own timing of the part under test)."""
    import torch
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out.append(r if isinstance(r, float) else time.perf_counter() - t)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=4)
    args = parser.parse_args(argv)
    import numpy as np
    import torch
    sys.path.insert(0, HERE)
    import chip_smoke
    from segmentation3d_tpu_torch.core.seg_infer import _upload
    from segmentation3d_tpu_torch.io import Volume, read_image, write_image
    dev = torch.device("cuda")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as d:
        ct = os.path.join(d, "ct.nii.gz")
        chip_smoke.make_ct(ct)
        vol = read_image(ct)
        a = np.asarray(vol.data)
        mask_dev = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) > 0).to(torch.uint8)
        pinned_mask = torch.empty(mask_dev.shape, dtype=torch.uint8, pin_memory=True)
        pinned_mask.copy_(mask_dev)
        plain_mask = np.array(pinned_mask.numpy())

        def read_in_thread():
            t = threading.Thread(target=read_image, args=(ct,))
            t.start()
            t.join()

        def write_fresh_cpu_copy():
            m = mask_dev.cpu().numpy()  # as the serial loop made the mask
            t = time.perf_counter()
            write_image(Volume(m, vol.frame), os.path.join(d, "f.mha"))
            return time.perf_counter() - t
        steps = {
            "read_image": lambda: read_image(ct),
            "read_image_in_thread": read_in_thread,
            "upload_pinned": lambda: _upload(a, dev),
            "pin_alloc": lambda: torch.empty(a.shape, dtype=torch.int16, pin_memory=True),
            "upload_pageable": lambda: torch.from_numpy(np.ascontiguousarray(a)).to(dev),
            "upload_float32_pageable":
                lambda: torch.from_numpy(np.asarray(a, np.float32)).to(dev),
            "write_mask_pinned": lambda: write_image(
                Volume(pinned_mask.numpy(), vol.frame), os.path.join(d, "p.mha")),
            "cpu_copy_mask": lambda: mask_dev.cpu(),
            "write_mask_fresh_cpu_copy": write_fresh_cpu_copy,
            "write_mask_numpy": lambda: write_image(
                Volume(plain_mask, vol.frame), os.path.join(d, "n.mha")),
        }
        for name, fn in steps.items():
            print(json.dumps({"step": name, "seconds": timed(fn, args.reps),
                              "voxels": int(a.size), "dtype": str(a.dtype),
                              "cpu_count": os.cpu_count(), "gpu": gpu}), flush=True)


if __name__ == "__main__":
    main()
