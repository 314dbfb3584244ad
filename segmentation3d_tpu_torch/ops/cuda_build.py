"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled by ``nvcc``
for ``sm_90a`` into ``build/kernels/<name>_<hash>.so`` (the hash covers the
source, every ``csrc/*.cuh`` header it may include and the flags, so an
edited source or header rebuilds) and loaded with
``ctypes``. Nothing is built when a module is imported: a kernel's wrapper
loads its library at its first launch, and :func:`build_all` builds every
source at once, one ``nvcc`` process each, all started together.

``python -m segmentation3d_tpu_torch.ops.cuda_build --report`` (on a machine
with ``nvcc``) builds each source once more with ``-Xptxas -v`` and prints,
per kernel, ptxas's registers, shared memory, spills and warnings, and the
count of ``HGMMA`` / ``IGMMA`` (wgmma) instructions in its SASS
(``cuobjdump -sass``).
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import sys
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


def sources() -> list[str]:
    """The kernel names: one per ``csrc/*.cu``."""
    return sorted(os.path.basename(p)[:-3]
                  for p in glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to: named by the hash of the source,
    of every ``csrc/*.cuh`` header (by name and content) and of the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    paths = [os.path.join(CSRC, f"{name}.cu")] + sorted(
        glob.glob(os.path.join(CSRC, "*.cuh")))
    for path in paths:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read() + b"\0")
    return os.path.join(BUILD_DIR, f"{name}_{h.hexdigest()[:16]}.so")


def build_all(names=None) -> dict:
    """Compile every source of ``names`` (default: all of ``csrc/``) that is
    not built yet, one ``nvcc`` each, in parallel. Returns ``{name: path}``;
    raises if any build fails."""
    names = sources() if names is None else list(names)
    out = {n: library_path(n) for n in names}
    todo = [n for n in names if not os.path.isfile(out[n])]
    if not todo:
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = f"{out[n]}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
    errors = []
    for n, (tmp, p) in procs.items():
        _, err = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc failed on {n}.cu ({p.returncode}):\n{err}")
        else:
            os.replace(tmp, out[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


_LIBS = {}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded ``csrc/<name>.cu`` library (built on first use)."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(build_all([name])[name])
    return _LIBS[name]


def report(names=None) -> dict:
    """Per source: ptxas's ``-v`` lines (registers, spills, warnings) and
    the number of wgmma instructions (``HGMMA``, ``IGMMA``) in its SASS."""
    names = sources() if names is None else list(names)
    nvcc = _nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for n in names:
            lib = os.path.join(tmp, f"{n}.so")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", lib,
                   os.path.join(CSRC, f"{n}.cu")]
            procs[n] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
        for n, (lib, p) in procs.items():
            log, _ = p.communicate()
            sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                                  text=True).stdout if p.returncode == 0 else ""
            out[n] = dict(
                returncode=p.returncode,
                ptxas=[ln for ln in log.splitlines()
                       if re.search(r"registers|spill|warning|error|C\d{4}|serializ|"
                                    r"Compiling entry", ln)],
                hgmma=len(re.findall(r"\bHGMMA\.", sass)),
                igmma=len(re.findall(r"\bIGMMA\.", sass)))
    return out


if __name__ == "__main__":
    if sys.argv[1:] != ["--report"]:
        sys.exit("usage: python -m segmentation3d_tpu_torch.ops.cuda_build --report")
    for name, r in report().items():
        print(f"== {name}: nvcc rc {r['returncode']}, SASS HGMMA {r['hgmma']}, "
              f"IGMMA {r['igmma']}")
        print("\n".join(r["ptxas"]))
