"""int8 inference forward for V-Net and its calibration — the port of the
int8 half of ``segmentation3d_tpu/models/packed_vnet.py``
(``build_packed_forward(quant="int8")``, default route, and
``calibrate_int8``).

Every conv between the stem and the softmax runs int8 x int8 -> int32, and
every activation between them is int8 at a STATIC per-site scale:

- weights: BN-folded (:func:`..models.fused_vnet.fold_net`), then
  per-output-channel symmetric int8 (:func:`..ops.quant.quantize_weight_np`),
  on the host at build time;
- activation scales: ``act_clip / 127`` uncalibrated, or
  ``max(amax, 1e-6) * calib_margin / 127`` from a :func:`calibrate_int8`
  dict; a concat's deconv and skip sites share the larger of their scales,
  so the int8 concat is exact;
- each int8 site's epilogue, in float32 and in this order:
  ``a = act(f32(acc) * s + b)`` with ``s = f32(s_w * f32(s_in))`` per output
  channel, then an int8 requant ``clip(round(a * f32(1 / s_out)))``; the
  last conv of a residual chain ends ``act_out(f32(id) * s_id + a)`` and
  requantizes at the block's own scale; the head writes ``dtype``.

The stem (bf16 operands, float32 sum) goes through ``thin_conv3d`` and
requantizes to int8 in its epilogue; every stride-1 3^3 int8 conv goes
through ``window_conv_i8``; the 2^3/s2 down conv and deconv are int8 GEMMs
(``ops/quant.py``); the 1x1 projection and the float32 softmax stay as in
the bf16 forward. Layout is channels-last throughout.
"""
from __future__ import annotations

import numpy as np
import torch

from segmentation3d_tpu_torch.models.fused_vnet import build_fused_forward, fold_net
from segmentation3d_tpu_torch.models.vnet import SegmentationNet
from segmentation3d_tpu_torch.ops.quant import (
    deconv_i8, deconv_weight, dequant_act_requant, down_conv_i8, down_weight,
    f32, quantize_weight_np,
)
from segmentation3d_tpu_torch.ops.thin_conv import thin_conv3d
from segmentation3d_tpu_torch.ops.window_i8 import window_conv_i8
from segmentation3d_tpu_torch.utils.device import no_tf32


def site_graph(net: SegmentationNet):
    """``(sites_in, unify_pairs)``: every activation site mapped to the site
    that produces its input (``None`` for the stem; a residual block's own
    key to its identity's producer), and the (deconv site, skip site) pair
    of each concat."""
    sites_in = {"in_block/conv": None}
    enc_sites = ["in_block/conv"]      # skip producers, in encoder order
    unify_pairs = []
    prev, c = "in_block/conv", net.base_channels
    for nconv in net.down_convs:
        c *= 2
        dk, rk = f"down_{c}/down", f"down_{c}/res"
        sites_in[dk] = prev
        rin = dk
        for j in range(nconv):
            sites_in[f"{rk}/conv{j}"] = rin
            rin = f"{rk}/conv{j}"
        sites_in[rk] = dk
        enc_sites.append(rk)
        prev = rk
    enc_sites.pop()                    # the bottom block feeds no skip
    for nconv in net.up_convs:
        uk, rk = f"up_{c}/up", f"up_{c}/res"
        sites_in[uk] = prev
        unify_pairs.append((uk, enc_sites.pop()))
        rin = uk                       # the concat carries the up/skip scale
        for j in range(nconv):
            sites_in[f"{rk}/conv{j}"] = rin
            rin = f"{rk}/conv{j}"
        sites_in[rk] = uk
        prev = rk
        c //= 2
    sites_in["out_block/conv"] = prev
    return sites_in, unify_pairs


def site_scales(net: SegmentationNet, act_clip: float = 8.0,
                calib: dict | None = None, calib_margin: float = 1.2) -> dict:
    """Each activation site's int8 scale (Python floats, as the JAX build
    computes them): ``act_clip / 127``, or from ``calib``'s maxima; concat
    partners unified to their max. A site missing from ``calib`` raises."""
    sites_in, unify_pairs = site_graph(net)

    def scale(k):
        if calib is None:
            return float(act_clip) / 127.0
        if k not in calib:
            raise ValueError(f"calib dict is missing activation site {k!r} "
                             "(use calibrate_int8 to produce it)")
        return max(float(calib[k]), 1e-6) * float(calib_margin) / 127.0

    s_out = {k: scale(k) for k in sites_in}
    for uk, sk in unify_pairs:
        s_out[uk] = s_out[sk] = max(s_out[uk], s_out[sk])
    return s_out


def build_int8_forward(net: SegmentationNet, act_clip: float = 8.0,
                       calib: dict | None = None, calib_margin: float = 1.2,
                       dtype=torch.bfloat16):
    """Fold and quantize ``net`` on the host and return
    ``forward(x [B,D,H,W,Cin]) -> probabilities [B,D,H,W,NC]`` (float32),
    the JAX package's int8 forward. ``dtype`` is the head conv's output
    type and the 1x1 projection's operand rounding (bf16, or float32 for
    parity tests). ``forward.sites`` holds each site's int8 weights,
    dequant vector ``s``, bias, ``inv_out`` (and, for residual blocks,
    ``s_id``) as built."""
    if getattr(net, "bottleneck", False):
        raise NotImplementedError("the int8 forward supports the standard "
                                  "(non-bottleneck) V-Net blocks")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dtype must be bfloat16 or float32, got {dtype}")
    device = next(net.parameters()).device
    act_kind = net.act
    sites_in, _ = site_graph(net)
    s_out = site_scales(net, act_clip, calib, calib_margin)
    folded = fold_net(net)

    def dev(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dt)

    sites = {}
    for key, f in folded.items():
        if key == "out_block/proj":
            continue
        if "n" in f:  # a residual block: its tail's identity and out scales
            sites[key] = {"n": f["n"], "alpha_out": f["alpha_out"],
                          "s_id": s_out[sites_in[key]],
                          "inv_out": 1.0 / s_out[key]}
            continue
        site = {"alpha": f["alpha"], "inv_out": 1.0 / s_out[key]}
        if key == "in_block/conv":  # the stem reads the full-precision patch
            site.update(w=dev(f["w"], torch.float32), b=dev(f["b"], torch.float32))
        else:
            wq, sw = quantize_weight_np(f["w"])
            if key.endswith("/down"):
                wk = down_weight(wq)
            elif key.endswith("/up"):
                wk = deconv_weight(wq)
            else:
                wk = wq
            site.update(w=dev(wk, torch.int8),
                        s=dev(sw * np.float32(s_out[sites_in[key]]), torch.float32),
                        b=dev(f["b"], torch.float32), w_dhwio=wq)
        sites[key] = site
    proj = folded["out_block/proj"]
    proj_w = dev(proj["w"], dtype).to(torch.float32)
    proj_b = dev(proj["b"], torch.float32)

    def strided(key, x):
        s = sites[key]

        def epilogue(y):
            return dequant_act_requant(y, s["s"], s["b"], act_kind, s["alpha"],
                                       s["inv_out"])
        op = deconv_i8 if key.endswith("/up") else down_conv_i8
        return op(x, s["w"], epilogue)

    def res_block(key, x):
        blk = sites[key]
        h = x
        for i in range(blk["n"]):
            s = sites[f"{key}/conv{i}"]
            kw = dict(out="int8", inv_out=s["inv_out"])
            if i == blk["n"] - 1:  # the chain's tail, at the block's scale
                kw = dict(out="int8", inv_out=blk["inv_out"], identity=x,
                          s_id=blk["s_id"], res_act=act_kind,
                          res_alpha=blk["alpha_out"])
            h = window_conv_i8(h, s["w"], s["s"], s["b"], act_kind, s["alpha"], **kw)
        return h

    head_out = "bf16" if dtype == torch.bfloat16 else "f32"

    @torch.inference_mode()
    def forward(x):
        with no_tf32():
            x = x.to(device=device).contiguous()
            s = sites["in_block/conv"]
            x = thin_conv3d(x, s["w"], s["b"], act=act_kind, alpha=s["alpha"],
                            quant_inv_sa=f32(s["inv_out"]))
            skips = [x]
            c = net.base_channels
            for i, _ in enumerate(net.down_convs):
                c *= 2
                x = res_block(f"down_{c}/res", strided(f"down_{c}/down", x))
                if i + 1 < len(net.down_convs):
                    skips.append(x)
            for _ in net.up_convs:
                x = torch.cat([strided(f"up_{c}/up", x), skips.pop()], dim=-1)
                x = res_block(f"up_{c}/res", x)
                c //= 2
            s = sites["out_block/conv"]
            x = window_conv_i8(x, s["w"], s["s"], s["b"], act_kind, s["alpha"],
                               out=head_out)
            logits = torch.matmul(x.to(torch.float32), proj_w) + proj_b
        return torch.softmax(logits, dim=-1)

    forward.sites = sites
    return forward


def calibrate_int8(net: SegmentationNet, samples, dtype=torch.bfloat16) -> dict:
    """Per-site activation maxima for :func:`build_int8_forward`'s
    ``calib``: the full-precision folded forward (``stats=True``) over
    ``samples`` (an iterable of ``[B,D,H,W,Cin]`` tensors), max over them."""
    fwd = build_fused_forward(net, dtype=dtype, stats=True)
    amax: dict = {}
    for x in samples:
        _, st = fwd(x)
        for k, v in st.items():
            amax[k] = max(amax.get(k, 0.0), v)
    return amax
