"""int8 building blocks of the quantized V-Net forward — the port of
``segmentation3d_tpu/ops/quant.py``.

- Weights: per-output-channel symmetric int8 (:func:`quantize_weight_np`).
- Activations: int8 at a static per-site scale; :func:`requant` rounds a
  float32 activation to it.
- The 2^3/s2 down conv and the 2^3/s2 transposed conv are plain int8 GEMMs
  with int32 accumulators (:func:`down_conv_i8`, :func:`deconv_i8`) through
  ``torch._int_mm``, exact on the card and on the CPU. The JAX package also
  leaves them to XLA, outside any Pallas kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from segmentation3d_tpu_torch.ops.thin_conv import activation


def f32(v) -> float:
    """``v`` rounded to float32, as a Python float: the value a float32
    kernel argument, or a weak-typed jnp scalar, holds."""
    return float(np.float32(v))


def quantize_weight_np(w: np.ndarray):
    """Per-output-channel symmetric int8: returns (w_q int8, s f32[cout])
    with ``w ≈ w_q * s`` (``w``'s LAST axis is the output channel). Zero
    channels get scale 1 (all-zero rows). ``np.rint`` rounds half to even."""
    w = np.asarray(w, np.float32)
    amax = np.max(np.abs(w), axis=tuple(range(w.ndim - 1)))
    s = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    w_q = np.clip(np.rint(w / s), -127, 127).astype(np.int8)
    return w_q, s


def requant(a, inv_out):
    """float32 activation -> int8 at scale ``1 / inv_out``:
    ``clip(round(a * f32(inv_out)), -127, 127)``. ``torch.round`` rounds
    half to even, as ``jnp.round`` does."""
    return torch.clamp(torch.round(a * f32(inv_out)), -127, 127).to(torch.int8)


def dequant_act_requant(acc, scale, bias, act, alpha, inv_out):
    """The int8 sites' epilogue on an int32 accumulator (channels last):
    ``requant(act(f32(acc) * scale + bias))``, a multiply then an add."""
    a = acc.to(torch.float32) * scale
    a = a + bias
    return requant(activation(a, act, f32(alpha)), inv_out)


def int_mm(a, w_nk):
    """Exact int8 GEMM ``a [M, K] @ w_nk [N, K].T -> int32 [M, N]``.
    ``torch._int_mm`` on a CUDA device takes K and N multiples of 8 (raised
    on here, on every device, so a CPU run shows the same failure) and
    M > 16 (smaller M is padded with zero rows)."""
    m, k = a.shape
    n = w_nk.shape[0]
    if k % 8 or n % 8:
        raise ValueError(f"int8 GEMM needs K and N multiples of 8, got "
                         f"K={k}, N={n}")
    pad = max(0, 17 - m)
    if pad:
        a = torch.cat([a, a.new_zeros(pad, k)])
    out = torch._int_mm(a.contiguous(), w_nk.t())
    return out[:m] if pad else out


def down_weight(w: np.ndarray) -> np.ndarray:
    """2^3 conv weight ``[2,2,2,Cin,Cout]`` -> the GEMM's ``[Cout, 8*Cin]``
    (K order dz, dy, dx, ci)."""
    kd, kh, kw, cin, cout = w.shape
    assert (kd, kh, kw) == (2, 2, 2)
    return np.ascontiguousarray(w.reshape(8 * cin, cout).T)


def deconv_weight(w: np.ndarray) -> np.ndarray:
    """2^3/s2 transposed-conv weight ``[2,2,2,Cin,Cout]`` (output voxel
    ``2z+dz`` takes ``x[z] @ w[dz]``) -> the GEMM's ``[8*Cout, Cin]`` (N
    order dz, dy, dx, co)."""
    kd, kh, kw, cin, cout = w.shape
    assert (kd, kh, kw) == (2, 2, 2)
    return np.ascontiguousarray(w.transpose(3, 0, 1, 2, 4).reshape(cin, 8 * cout).T)


def down_conv_i8(x, w_nk, epilogue=None):
    """2^3/s2 VALID conv of int8 ``x [B,D,H,W,Cin]`` with the GEMM weight
    :func:`down_weight`: a space-to-depth reshape plus one
    ``[N, 8*Cin] x [8*Cin, Cout]`` int8 GEMM -> int32
    ``[B,D/2,H/2,W/2,Cout]``, or what ``epilogue`` makes of it."""
    B, D, H, W, C = x.shape
    a = x.reshape(B, D // 2, 2, H // 2, 2, W // 2, 2, C)
    a = a.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, 8 * C)
    y = int_mm(a, w_nk).reshape(B, D // 2, H // 2, W // 2, -1)
    return epilogue(y) if epilogue is not None else y


def deconv_i8(x, w_nk, epilogue=None):
    """2^3/s2 transposed conv of int8 ``x [B,D,H,W,Cin]`` with the GEMM
    weight :func:`deconv_weight`: one ``[N, Cin] x [Cin, 8*Cout]`` int8 GEMM
    (``epilogue``, if any, applied on its output, so the shuffle moves its
    smaller result) plus a depth-to-space -> ``[B,2D,2H,2W,Cout]``."""
    B, D, H, W, C = x.shape
    y = int_mm(x.reshape(-1, C), w_nk)
    cout = y.shape[1] // 8
    y = y.reshape(B, D, H, W, 2, 2, 2, cout)
    if epilogue is not None:
        y = epilogue(y)
    y = y.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return y.reshape(B, 2 * D, 2 * H, 2 * W, cout)
