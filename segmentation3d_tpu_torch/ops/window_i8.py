"""int8 stride-1 SAME 3x3x3 conv with a fused dequant / act / requant
epilogue — the Hopper port of
``segmentation3d_tpu/ops/pallas_i8win.py:window_conv_i8_pallas``.

:func:`window_conv_i8` computes, on channels-last ``[B, D, H, W, Cin]`` int8
with ``w`` as ``[3, 3, 3, Cin, Cout]`` int8, in this value order:

- ``acc = conv(x, w)`` in int32 (exact);
- ``a = act(f32(acc) * scale + bias)`` (a multiply, then an add);
- optionally the residual tail ``a = res_act(f32(identity) * s_id + a)``;
- an int8 requant ``clip(round(a * inv_out), -127, 127)`` (round half to
  even), or ``a`` as bf16 / f32.

The TPU kernel's packed ``[B, D, H, cols, P*C]`` input is byte-identical to
this NDHWC tensor; its lane packing and y-tiling are not copied. On a CUDA
tensor it launches ``csrc/window_conv_i8.cu`` or raises (sites with
``Cin % 32 == 0`` take its wgmma path, planned and with the weights
repacked by :mod:`.conv_plan`, the others its direct path); on a CPU
tensor it runs :func:`window_conv_i8_reference`, the plain PyTorch version.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from segmentation3d_tpu_torch.ops.conv_plan import (
    pack_weights, plan_conv, uses_tensor_cores)
from segmentation3d_tpu_torch.ops.cuda_build import load_library
from segmentation3d_tpu_torch.ops.quant import f32, requant
from segmentation3d_tpu_torch.ops.thin_conv import activation

_ACTS = {"none": 0, "relu": 1, "prelu": 2}
_OUTS = {"bf16": (0, torch.bfloat16), "f32": (1, torch.float32),
         "int8": (2, torch.int8)}


def _lib():
    lib = load_library("window_conv_i8")
    if not hasattr(lib, "_bound"):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.window_conv_i8_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                                              i, i, f, i, f, f, i, f, p]
        lib.window_conv_i8_launch.restype = i
        lib.window_conv_i8_launch_wgmma.argtypes = [
            p, p, p, p, p, p, i, i, i, i, i, i, i, f, i, f, f, i, f, p, p]
        lib.window_conv_i8_launch_wgmma.restype = i
        lib.window_conv_i8_uses_tensor_cores.argtypes = [i, i]
        lib.window_conv_i8_uses_tensor_cores.restype = i
        lib._bound = True
    return lib


def kernel_path(cin: int, cout: int) -> str:
    """``"tensor_cores"`` (wgmma implicit GEMM) or ``"direct"``
    (``__dp4a``), as the built kernel decides it for a (cin, cout) site."""
    return "tensor_cores" if _lib().window_conv_i8_uses_tensor_cores(cin, cout) \
        else "direct"


def window_conv_i8_reference(x, w, scale, bias, act="relu", alpha=0.25, *,
                             out="int8", inv_out=None, identity=None,
                             s_id=None, res_act="none", res_alpha=0.25):
    """Plain PyTorch version: ``F.conv3d`` in float64 (exact for these
    integer sums, cuDNN off so no transform-based algorithm is picked),
    cast to int32, then the same float32 epilogue as separate ops."""
    xd = x.to(torch.float64).permute(0, 4, 1, 2, 3)
    wd = w.to(torch.float64).permute(4, 3, 0, 1, 2)
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv3d(xd, wd, padding=1).permute(0, 2, 3, 4, 1).to(torch.int32)
    a = acc.to(torch.float32) * scale.to(torch.float32)
    a = a + bias.to(torch.float32)
    a = activation(a, act, f32(alpha))
    if identity is not None:
        t = identity.to(torch.float32) * f32(s_id)
        a = activation(t + a, res_act, f32(res_alpha))
    if out == "int8":
        return requant(a, inv_out)
    return a.to(_OUTS[out][1])


def window_conv_i8(x, w, scale, bias, act="relu", alpha=0.25, *, out="int8",
                   inv_out=None, identity=None, s_id=None, res_act="none",
                   res_alpha=0.25):
    """Stride-1 SAME 3x3x3 int8 conv, ``x [B,D,H,W,Cin]`` x
    ``w [3,3,3,Cin,Cout]`` (both int8), with the dequant ``scale``/``bias``
    (float32 ``[Cout]``), ``act`` (none / relu / prelu(alpha)), an optional
    residual tail on ``identity [B,D,H,W,Cout]`` int8 at scale ``s_id``
    (``res_act`` relu / prelu(res_alpha)), and ``out`` "int8" (requant at
    ``inv_out``), "bf16" or "f32". A CUDA tensor launches the kernel; a CPU
    tensor runs :func:`window_conv_i8_reference`."""
    if x.dim() != 5 or w.dim() != 5 or tuple(w.shape[:3]) != (3, 3, 3):
        raise ValueError(f"expected x [B,D,H,W,Cin] and w [3,3,3,Cin,Cout], "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise ValueError(f"x and w must be int8, got {x.dtype} and {w.dtype}")
    cin, cout = int(w.shape[3]), int(w.shape[4])
    if x.shape[-1] != cin:
        raise ValueError(f"x has {x.shape[-1]} channels, w expects {cin}")
    if act not in _ACTS or res_act not in _ACTS:
        raise ValueError(f"unknown activation {act!r} / {res_act!r}")
    if out not in _OUTS:
        raise ValueError(f"out must be int8, bf16 or f32, got {out!r}")
    if (out == "int8") != (inv_out is not None):
        raise ValueError("inv_out is needed for, and only for, int8 output")
    if identity is not None:
        if identity.dtype != torch.int8 or \
                tuple(identity.shape) != tuple(x.shape[:4]) + (cout,):
            raise ValueError(f"identity must be int8 {tuple(x.shape[:4]) + (cout,)}")
        if s_id is None or res_act == "none":
            raise ValueError("a residual tail needs s_id and res_act")
    if tuple(scale.shape) != (cout,) or tuple(bias.shape) != (cout,):
        raise ValueError(f"scale and bias must be [{cout}]")
    if x.device.type == "cpu":
        return window_conv_i8_reference(
            x, w, scale, bias, act, alpha, out=out, inv_out=inv_out,
            identity=identity, s_id=s_id, res_act=res_act, res_alpha=res_alpha)
    if x.device.type != "cuda":
        raise ValueError(f"window_conv_i8 runs on CUDA or CPU, not {x.device}")
    tensors = [x, w, scale, bias] + ([identity] if identity is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("all inputs must be on the same device")
    xq, wq = x.contiguous(), w.contiguous()
    sq = scale.to(torch.float32).contiguous()
    bq = bias.to(torch.float32).contiguous()
    idq = identity.contiguous() if identity is not None else None
    if xq.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("x and w must be 16-byte aligned")
    B, D, H, W = (int(v) for v in xq.shape[:4])
    if B * D * H * W >= 2 ** 31 * 64:
        raise ValueError(f"volume of {B * D * H * W} voxels is too large")
    kind, dtype = _OUTS[out]
    res = torch.empty((B, D, H, W, cout), device=x.device, dtype=dtype)
    args = (B, D, H, W, cin, cout, _ACTS[act], f32(alpha),
            _ACTS[res_act] if idq is not None else 0, f32(res_alpha),
            f32(s_id or 0.0), kind, f32(inv_out or 0.0))
    ptrs = (sq.data_ptr(), bq.data_ptr(),
            idq.data_ptr() if idq is not None else None, res.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if uses_tensor_cores(cin, cout):
            plan = plan_conv(B, D, H, W, cin, cout, 1)
            wp, arr = pack_weights(wq, plan), plan.as_array()
            err = _lib().window_conv_i8_launch_wgmma(
                xq.data_ptr(), wp.data_ptr(), *ptrs, *args, arr.ctypes.data,
                stream)
        else:
            err = _lib().window_conv_i8_launch(
                xq.data_ptr(), wq.data_ptr(), *ptrs, *args, stream)
    if err != 0:
        raise RuntimeError(f"window_conv_i8 kernel launch failed: CUDA error {err}")
    window_conv_i8.launches += 1
    return res


#: kernel launches so far (incremented only where the kernel is launched)
window_conv_i8.launches = 0
