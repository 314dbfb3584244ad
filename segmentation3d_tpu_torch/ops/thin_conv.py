"""Stride-1 SAME 3x3x3 conv with a fused epilogue — the Hopper port of
``segmentation3d_tpu/ops/pallas_conv.py:thin_conv3d``.

:func:`thin_conv3d` computes ``q(act2(x + act(conv(x, w) + b)))`` on
channels-last ``[B, D, H, W, Cin]`` with ``w`` as ``[3, 3, 3, Cin, Cout]``:
bf16 operands, f32 accumulation, f32 epilogue, bf16 / f32 / int8 output.
On a CUDA tensor it launches the hand-written kernel in
``csrc/thin_conv3d.cu`` (built with ``nvcc`` at first use into ``build/``
and loaded with ``ctypes``) or raises; on a CPU tensor it runs
:func:`thin_conv3d_reference`, the plain PyTorch version of the same
function. :func:`fold_bn_np` folds inference BatchNorm into the conv.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np
import torch
import torch.nn.functional as F

from segmentation3d_tpu_torch.utils.device import no_tf32

_ACTS = {"none": 0, "relu": 1, "prelu": 2}
_OUT_KINDS = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc", "thin_conv3d.cu")
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO, "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


def fold_bn_np(w, b, scale, bias, mean, var, eps: float = 1e-5):
    """Fold inference BatchNorm into a conv, in numpy f32:
    ``bn(conv(x, w) + b) == conv(x, w') + b'``. ``w``'s LAST axis is the
    output channel (DHWIO; a torch weight is transposed to it first)."""
    w = np.asarray(w, np.float32)
    s = np.asarray(scale, np.float32) / np.sqrt(
        np.asarray(var, np.float32) + eps)
    w2 = w * s[None, None, None, None, :]
    b0 = np.asarray(b, np.float32) if b is not None else np.float32(0.0)
    b2 = (b0 - np.asarray(mean, np.float32)) * s \
        + np.asarray(bias, np.float32)
    return w2, b2


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
                       "to build the thin_conv3d kernel")


def build_library() -> str:
    """Compile ``csrc/thin_conv3d.cu`` for sm_90a into ``build/kernels``
    (named by the source's hash, so an edited source rebuilds). Returns the
    path of the shared library."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"thin_conv3d_{digest}.so")
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, _SRC]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


_LIB = {}


def _lib():
    """The loaded kernel library (built on first use)."""
    if "lib" not in _LIB:
        lib = ctypes.CDLL(build_library())
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.thin_conv3d_launch.argtypes = [p, p, p, p, i, i, i, i, i, i,
                                           i, f, i, f, i, f, p]
        lib.thin_conv3d_launch.restype = i
        lib.thin_conv3d_uses_tensor_cores.argtypes = [i, i]
        lib.thin_conv3d_uses_tensor_cores.restype = i
        _LIB["lib"] = lib
    return _LIB["lib"]


def kernel_path(cin: int, cout: int) -> str:
    """Which of the kernel's two paths a (cin, cout) site takes:
    ``"tensor_cores"`` (implicit GEMM) or ``"direct"`` (CUDA cores), as the
    built kernel decides it."""
    return "tensor_cores" if _lib().thin_conv3d_uses_tensor_cores(cin, cout) \
        else "direct"


def _epilogue(acc, x32, act, alpha, residual, res_alpha, quant_inv_sa,
              out_dtype):
    acc = activation(acc, act, alpha)
    if residual != "none":
        acc = activation(acc + x32, residual, res_alpha)
    if quant_inv_sa is not None:
        # torch.round rounds half to even, as jnp.round does
        return torch.clamp(torch.round(acc * quant_inv_sa), -127, 127).to(torch.int8)
    return acc.to(out_dtype)


def activation(x, kind, alpha=0.25):
    """none / relu / prelu(alpha), as the kernel's epilogue applies them."""
    if kind == "relu":
        return torch.clamp_min(x, 0.0)
    if kind == "prelu":
        return torch.where(x >= 0, x, alpha * x)
    if kind == "none":
        return x
    raise ValueError(f"unknown activation {kind!r}")


def thin_conv3d_reference(x, w, b=None, act: str = "none", alpha: float = 0.25,
                          out_dtype=torch.bfloat16, residual: str = "none",
                          res_alpha: float = 0.25,
                          quant_inv_sa: float | None = None):
    """Plain PyTorch version of the kernel: x and w rounded to bf16 (the
    kernel's operand rounding), ``F.conv3d`` in f32 with TF32 off, then the
    same epilogue (the residual identity is the bf16-rounded input)."""
    x32 = x.to(torch.bfloat16).to(torch.float32)
    w32 = w.to(torch.bfloat16).to(torch.float32)
    with no_tf32():
        acc = F.conv3d(x32.permute(0, 4, 1, 2, 3), w32.permute(4, 3, 0, 1, 2),
                       padding=1).permute(0, 2, 3, 4, 1)
    if b is not None:
        acc = acc + b.to(torch.float32)
    return _epilogue(acc, x32, act, alpha, residual, res_alpha, quant_inv_sa,
                     out_dtype)


def thin_conv3d(x, w, b=None, act: str = "none", alpha: float = 0.25,
                out_dtype=torch.bfloat16, residual: str = "none",
                res_alpha: float = 0.25, quant_inv_sa: float | None = None):
    """Stride-1 SAME 3x3x3 conv, ``x [B,D,H,W,Cin]`` x ``w [3,3,3,Cin,Cout]``
    (+ ``b [Cout]``) with the fused epilogue ``act`` (none / relu / prelu),
    optional residual tail ``residual`` (none / relu / prelu; needs
    cin == cout) and optional int8 requant at ``quant_inv_sa`` (the output
    is then int8). A CUDA tensor launches the kernel; a CPU tensor runs
    :func:`thin_conv3d_reference`."""
    if x.dim() != 5 or tuple(w.shape[:3]) != (3, 3, 3) or w.dim() != 5:
        raise ValueError(f"expected x [B,D,H,W,Cin] and w [3,3,3,Cin,Cout], "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    cin, cout = int(w.shape[3]), int(w.shape[4])
    if x.shape[-1] != cin:
        raise ValueError(f"x has {x.shape[-1]} channels, w expects {cin}")
    if residual != "none" and cin != cout:
        raise ValueError(f"fused residual needs cin == cout, got {cin}->{cout}")
    if act not in _ACTS or residual not in _ACTS:
        raise ValueError(f"unknown activation {act!r} / residual {residual!r}")
    if quant_inv_sa is not None:
        out_dtype = torch.int8
    if out_dtype not in _OUT_KINDS:
        raise ValueError(f"out_dtype must be bf16, f32 or int8, got {out_dtype}")
    if out_dtype == torch.int8 and quant_inv_sa is None:
        raise ValueError("int8 output needs quant_inv_sa")
    if x.device.type == "cpu":
        return thin_conv3d_reference(x, w, b, act, alpha, out_dtype, residual,
                                     res_alpha, quant_inv_sa)
    if x.device.type != "cuda":
        raise ValueError(f"thin_conv3d runs on CUDA or CPU, not {x.device}")
    if w.device != x.device or (b is not None and b.device != x.device):
        raise ValueError("x, w and b must be on the same device")
    xq = x.to(torch.bfloat16).contiguous()
    wq = w.to(torch.bfloat16).contiguous()
    bq = (torch.zeros(cout, device=x.device, dtype=torch.float32) if b is None
          else b.to(torch.float32).contiguous())
    if bq.shape != (cout,):
        raise ValueError(f"b must be [{cout}], got {tuple(bq.shape)}")
    if xq.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("x and w must be 16-byte aligned")
    B, D, H, W = (int(v) for v in xq.shape[:4])
    if B * D * H * W >= 2 ** 31 * 64:
        raise ValueError(f"volume of {B * D * H * W} voxels is too large")
    out = torch.empty((B, D, H, W, cout), device=x.device, dtype=out_dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().thin_conv3d_launch(
            xq.data_ptr(), wq.data_ptr(), bq.data_ptr(), out.data_ptr(),
            B, D, H, W, cin, cout, _ACTS[act], float(alpha),
            _ACTS[residual], float(res_alpha), _OUT_KINDS[out_dtype],
            float(quant_inv_sa or 0.0), stream)
    if err != 0:
        raise RuntimeError(f"thin_conv3d kernel launch failed: CUDA error {err}")
    thin_conv3d.launches += 1
    return out


#: kernel launches so far (incremented only where the kernel is launched)
thin_conv3d.launches = 0
