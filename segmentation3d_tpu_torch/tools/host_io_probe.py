"""Time the host steps of one case around the device, on one GPU.

- the NIfTI read split: the file read, the gunzip through libdeflate
  (``native.gunzip``) and through the zlib loop (``nifti.zlib_gunzip``), the
  parse; the whole ``read_image`` on the calling thread, on another, and on
  2 up to as many threads at once as the read-ahead starts
  (``default_decoders``), one case each;
- the DICOM series read of the same voxels (one uncompressed file per
  slice) split into the file read + element parse and the pixel decode, and
  the pixel decode per slice of an RLE and a JPEG Lossless slab;
- the upload as the read-ahead does it (pinned buffer, copy into it,
  host-to-device copy) and as a pageable copy;
- the write of the mask from a pinned buffer, from a fresh pageable
  ``.cpu()`` copy (timing the write alone) and from a numpy array.

Each step runs ``--reps`` times in one process; prints one JSON line per
step (seconds of every repetition, null for the libdeflate gunzip where
that build did not load; ``per``: what one repetition covers) with the
card's name and power limit and the codec's build.

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
#: slices of the RLE and JPEG Lossless slabs (their encoders are pure Python)
SLAB = 8


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
    from segmentation3d_tpu_torch import native
    from segmentation3d_tpu_torch.core.seg_infer import _upload, default_decoders
    from segmentation3d_tpu_torch.io import Volume, dicom, nifti, read_image, write_image
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

        def read_in_threads(n):
            threads = [threading.Thread(target=read_image, args=(ct,))
                       for _ in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()

        def file_read():
            with open(ct, "rb") as f:
                return f.read()
        raw = file_read()
        payload = nifti.gunzip(raw)

        def parse_nifti():
            h = nifti._Hdr(payload[:348], ct)
            h.read_data_bytes(payload, ct)
            h.frame()

        series = os.path.join(d, "series")
        dicom.write_dicom_series(series, a, vol.frame)
        files = sorted(os.path.join(series, f) for f in os.listdir(series))
        parsed = [dicom._read_file(p) for p in files]
        slabs = {}
        for syntax in ("rle", "jpeg_lossless"):
            folder = os.path.join(d, syntax)
            dicom.write_dicom_series(folder, a[:SLAB], vol.frame, compress=syntax)
            slabs[syntax] = [(dicom._read_file(os.path.join(folder, f)), f)
                             for f in sorted(os.listdir(folder))]

        def decode(items):
            return lambda: [dicom._file_slices(e, p) for e, p in items]

        def write_fresh_cpu_copy():
            m = mask_dev.cpu().numpy()  # as the serial loop made the mask
            t = time.perf_counter()
            write_image(Volume(m, vol.frame), os.path.join(d, "f.mha"))
            return time.perf_counter() - t
        steps = {
            "file_read": (file_read, "case"),
            # None where the libdeflate build did not load: nothing to time
            "gunzip_libdeflate": ((lambda: native.gunzip(raw))
                                  if native.codec().has_gzip else None, "case"),
            "gunzip_zlib": (lambda: nifti.zlib_gunzip(raw), "case"),
            "parse": (parse_nifti, "case"),
            "read_image": (lambda: read_image(ct), "case"),
            "read_image_in_thread": (lambda: read_in_threads(1), "case"),
            **{f"read_image_{k}_threads": ((lambda k=k: read_in_threads(k)), f"{k} cases")
               for k in range(2, default_decoders() + 1)},
            "dicom_file_read_parse": (lambda: [dicom._read_file(p) for p in files],
                                      f"{len(files)} slices"),
            "dicom_decode_native": (decode(list(zip(parsed, files))),
                                    f"{len(files)} slices"),
            "read_dicom_series": (lambda: read_image(series), f"{len(files)} slices"),
            "dicom_decode_rle": (decode(slabs["rle"]), f"{SLAB} slices"),
            "dicom_decode_jpeg_lossless": (decode(slabs["jpeg_lossless"]),
                                           f"{SLAB} slices"),
            "upload_pinned": (lambda: _upload(a, dev), "case"),
            "pin_alloc": (lambda: torch.empty(a.shape, dtype=torch.int16,
                                              pin_memory=True), "case"),
            "upload_pageable": (lambda: torch.from_numpy(np.ascontiguousarray(a)).to(dev),
                                "case"),
            "upload_float32_pageable":
                (lambda: torch.from_numpy(np.asarray(a, np.float32)).to(dev), "case"),
            "write_mask_pinned": (lambda: write_image(
                Volume(pinned_mask.numpy(), vol.frame), os.path.join(d, "p.mha")), "case"),
            "cpu_copy_mask": (lambda: mask_dev.cpu(), "case"),
            "write_mask_fresh_cpu_copy": (write_fresh_cpu_copy, "case"),
            "write_mask_numpy": (lambda: write_image(
                Volume(plain_mask, vol.frame), os.path.join(d, "n.mha")), "case"),
        }
        for name, (fn, per) in steps.items():
            print(json.dumps({"step": name,
                              "seconds": timed(fn, args.reps) if fn else None,
                              "per": per, "voxels": int(a.size), "dtype": str(a.dtype),
                              "cpu_count": os.cpu_count(), "codec": native.status(),
                              "gpu": gpu}), flush=True)


if __name__ == "__main__":
    main()
