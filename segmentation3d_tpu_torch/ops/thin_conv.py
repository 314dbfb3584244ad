"""Stride-1 SAME 3x3x3 conv with a fused epilogue — the Hopper port of
``segmentation3d_tpu/ops/pallas_conv.py:thin_conv3d``.

:func:`thin_conv3d` computes ``q(act2(x + act(conv(x, w) + b)))`` on
channels-last ``[B, D, H, W, Cin]`` with ``w`` as ``[3, 3, 3, Cin, Cout]``:
bf16 operands, f32 accumulation, f32 epilogue, bf16 / f32 / int8 output.
On a CUDA tensor it launches the hand-written kernel in
``csrc/thin_conv3d.cu`` (built with ``nvcc`` at first use into ``build/``
and loaded with ``ctypes``, :mod:`.cuda_build`) or raises: sites with
``Cin % 32 == 0`` take its wgmma path, with the geometry planned and the
weights repacked by :mod:`.conv_plan`, the others its direct path. On a
CPU tensor it runs :func:`thin_conv3d_reference`, the plain PyTorch
version of the same function. :func:`fold_bn_np` folds inference BatchNorm into the conv.

``thin_conv3d.launches`` counts the kernel's launches that run. A call made
while the current stream captures a CUDA graph runs nothing: it counts in
:func:`recorded_launches` instead, and whoever replays the graph adds what
its capture recorded to ``thin_conv3d.launches`` at each replay.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch
import torch.nn.functional as F

from segmentation3d_tpu_torch.ops.conv_plan import (
    pack_weights, plan_conv, uses_tensor_cores)
from segmentation3d_tpu_torch.ops.cuda_build import load_library
from segmentation3d_tpu_torch.utils.device import no_tf32

_ACTS = {"none": 0, "relu": 1, "prelu": 2}
_OUT_KINDS = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}


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


def _lib():
    """The loaded kernel library (built on first use)."""
    lib = load_library("thin_conv3d")
    if not hasattr(lib, "_bound"):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.thin_conv3d_launch.argtypes = [p, p, p, p, i, i, i, i, i, i,
                                           i, f, i, f, i, f, p]
        lib.thin_conv3d_launch.restype = i
        lib.thin_conv3d_launch_wgmma.argtypes = [p, p, p, p, i, i, i, i, i, i,
                                                 i, f, i, f, i, f, p, p]
        lib.thin_conv3d_launch_wgmma.restype = i
        lib.thin_conv3d_uses_tensor_cores.argtypes = [i, i]
        lib.thin_conv3d_uses_tensor_cores.restype = i
        lib._bound = True
    return lib


def kernel_path(cin: int, cout: int) -> str:
    """Which of the kernel's two paths a (cin, cout) site takes:
    ``"tensor_cores"`` (wgmma implicit GEMM) or ``"direct"`` (CUDA cores),
    as the built kernel decides it."""
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
    args = (_ACTS[act], float(alpha), _ACTS[residual], float(res_alpha),
            _OUT_KINDS[out_dtype], float(quant_inv_sa or 0.0))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if uses_tensor_cores(cin, cout):
            plan = plan_conv(B, D, H, W, cin, cout, 2)
            wp, arr = pack_weights(wq, plan), plan.as_array()
            err = _lib().thin_conv3d_launch_wgmma(
                xq.data_ptr(), wp.data_ptr(), bq.data_ptr(), out.data_ptr(),
                B, D, H, W, cin, cout, *args, arr.ctypes.data, stream)
        else:
            err = _lib().thin_conv3d_launch(
                xq.data_ptr(), wq.data_ptr(), bq.data_ptr(), out.data_ptr(),
                B, D, H, W, cin, cout, *args, stream)
    if err != 0:
        raise RuntimeError(f"thin_conv3d kernel launch failed: CUDA error {err}")
    count_launch()
    return out


#: kernel launches so far (incremented only where the kernel is launched)
thin_conv3d.launches = 0

_recorded = threading.local()


def count_launch():
    """Count one launch of the kernel: in ``thin_conv3d.launches``, or, while
    this thread's current stream captures a CUDA graph (nothing runs), in
    this thread's :func:`recorded_launches`."""
    if torch.cuda.is_current_stream_capturing():
        _recorded.n = recorded_launches() + 1
    else:
        thin_conv3d.launches += 1


def recorded_launches() -> int:
    """The launches this thread has recorded into CUDA graph captures."""
    return getattr(_recorded, "n", 0)
