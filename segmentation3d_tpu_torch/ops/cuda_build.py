"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled by ``nvcc``
for ``sm_90a`` into ``build/kernels/<name>_<hash>.so`` (the hash covers the
source and the flags, so an edited source rebuilds) and loaded with
``ctypes``. Nothing is built when a module is imported: a kernel's wrapper
loads its library at its first launch, and :func:`build_all` builds every
source at once, one ``nvcc`` process each, all started together.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

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
    """Where ``csrc/<name>.cu`` builds to (named by its content hash)."""
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{name}_{digest}.so")


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
