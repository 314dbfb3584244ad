"""Fused inference forward for V-Net: BN folded into every conv, every
stride-1 3x3x3 conv through the hand-written kernel.

The port of ``segmentation3d_tpu/models/fused_vnet.py:build_fused_forward``
with its Pallas routing on. At inference BatchNorm is a per-channel affine,
so it folds into the preceding conv (:func:`fold_bn_np`); the activation,
and for single-conv residual blocks the whole tail ``act(x + .)``, fuse
into the conv's epilogue (:func:`thin_conv3d`):

- the stem (in_channels -> base), every residual conv and the head conv
  (-> num_classes) run through :func:`thin_conv3d`;
- multi-conv residual chains end with a plain ``act(x + h)``;
- the 2^3/s2 down conv, the 2^3/s2 transposed conv, the skip concat, the
  1x1 projection and the float32 softmax stay torch ops.

Layout is channels-last ``[B, D, H, W, C]`` throughout; torch's convs see
``channels_last_3d`` views of it.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from segmentation3d_tpu_torch.models.vnet import SegmentationNet
from segmentation3d_tpu_torch.ops.thin_conv import (
    activation, fold_bn_np, thin_conv3d,
)
from segmentation3d_tpu_torch.utils.device import no_tf32


def _ncdhw(x):
    """[B,D,H,W,C] -> a [B,C,D,H,W] view (channels_last_3d strides)."""
    return x.permute(0, 4, 1, 2, 3)


def _ndhwc(x):
    return x.permute(0, 2, 3, 4, 1).contiguous()


def build_fused_forward(net: SegmentationNet, dtype=torch.bfloat16):
    """Fold ``net``'s weights (host numpy, float32) and return
    ``forward(x [B,D,H,W,Cin]) -> probabilities [B,D,H,W,NC]`` (float32)
    computing the same function as ``net`` in eval mode, within bf16
    tolerance. ``dtype`` is the activation type between layers (bf16 for
    inference; float32 for parity tests). The folded weights live where
    ``net``'s parameters are."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dtype must be bfloat16 or float32, got {dtype}")
    device = next(net.parameters()).device
    sd = {k: v.detach().to("cpu", torch.float32).numpy()
          for k, v in net.state_dict().items() if v.is_floating_point()}
    act_kind = net.act

    def alpha_of(prefix):
        key = f"{prefix}.alpha"
        return float(sd[key].reshape(-1)[0]) if act_kind == "prelu" else 0.25

    def dev(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dt)

    sites = {}

    def reg_conv(key, prefix, residual_alpha=None):
        # torch [O,I,3,3,3] -> DHWIO, fold over the output channel (last)
        w, b = fold_bn_np(sd[f"{prefix}.conv.weight"].transpose(2, 3, 4, 1, 0),
                          sd.get(f"{prefix}.conv.bias"),
                          sd[f"{prefix}.bn.weight"], sd[f"{prefix}.bn.bias"],
                          sd[f"{prefix}.bn.running_mean"],
                          sd[f"{prefix}.bn.running_var"])
        sites[key] = {"w": dev(w, torch.bfloat16), "b": dev(b, torch.float32),
                      "alpha": alpha_of(f"{prefix}.act"),
                      "res_alpha": residual_alpha}

    def reg_strided(key, prefix, conv, bn, act, transpose):
        w = sd[f"{prefix}.{conv}.weight"]
        # to a DHW..O layout whose last axis is the output channel: a conv
        # weight is [O,I,k,k,k], a transposed-conv weight [I,O,k,k,k]
        perm = (2, 3, 4, 0, 1) if transpose else (2, 3, 4, 1, 0)
        inv = (3, 4, 0, 1, 2) if transpose else (4, 3, 0, 1, 2)
        w, b = fold_bn_np(w.transpose(perm), sd.get(f"{prefix}.{conv}.bias"),
                          sd[f"{prefix}.{bn}.weight"], sd[f"{prefix}.{bn}.bias"],
                          sd[f"{prefix}.{bn}.running_mean"],
                          sd[f"{prefix}.{bn}.running_var"])
        sites[key] = {"w": dev(w.transpose(inv), dtype), "b": dev(b, dtype),
                      "transpose": transpose, "alpha": alpha_of(f"{prefix}.{act}")}

    def reg_res_block(key, prefix, num_convs):
        alpha_out = alpha_of(f"{prefix}.act_out")
        for i in range(num_convs):
            # a single-conv block fuses act_out(x + .) into the conv
            reg_conv(f"{key}/conv{i}", f"{prefix}.conv{i}",
                     residual_alpha=alpha_out if num_convs == 1 else None)
        sites[key] = {"n": num_convs, "alpha_out": alpha_out}

    reg_conv("in_block/conv", "in_block.conv")
    c = net.base_channels
    for n in net.down_convs:
        c *= 2
        reg_strided(f"down_{c}/down", f"down_{c}", "down_conv", "down_bn",
                    "down_act", transpose=False)
        reg_res_block(f"down_{c}/res", f"down_{c}.res", n)
    for n in net.up_convs:
        reg_strided(f"up_{c}/up", f"up_{c}", "up_conv", "up_bn", "up_act",
                    transpose=True)
        reg_res_block(f"up_{c}/res", f"up_{c}.res", n)
        c //= 2
    reg_conv("out_block/conv", "out_block.conv")
    # 1x1 projection: bf16-rounded operands (under bf16), f32 accumulation
    pw = sd["out_block.proj.weight"][:, :, 0, 0, 0].T  # [I, O]
    proj_w = dev(pw, dtype).to(torch.float32)
    proj_b = dev(sd["out_block.proj.bias"], torch.float32)

    def run_conv(key, x):
        s = sites[key]
        fused_tail = s["res_alpha"] is not None
        return thin_conv3d(x, s["w"], s["b"], act=act_kind, alpha=s["alpha"],
                           out_dtype=dtype,
                           residual=act_kind if fused_tail else "none",
                           res_alpha=s["res_alpha"] if fused_tail else 0.25)

    def run_strided(key, x):
        s = sites[key]
        if s["transpose"]:
            out = F.conv_transpose3d(_ncdhw(x), s["w"], stride=2)
        else:
            out = F.conv3d(_ncdhw(x), s["w"], stride=2)
        out = _ndhwc(out) + s["b"]
        return activation(out, act_kind, s["alpha"]).to(dtype)

    def run_res_block(key, x):
        s = sites[key]
        if s["n"] == 1:
            return run_conv(f"{key}/conv0", x)
        h = x
        for i in range(s["n"]):
            h = run_conv(f"{key}/conv{i}", h)
        return activation(x + h, act_kind, s["alpha_out"]).to(dtype)

    down_convs, up_convs, base = net.down_convs, net.up_convs, net.base_channels

    @torch.inference_mode()
    def forward(x):
        with no_tf32():
            x = x.to(device=device, dtype=dtype).contiguous()
            c = base
            x = run_conv("in_block/conv", x)
            skips = [x]
            for i, _ in enumerate(down_convs):
                c *= 2
                x = run_strided(f"down_{c}/down", x)
                x = run_res_block(f"down_{c}/res", x)
                if i + 1 < len(down_convs):
                    skips.append(x)
            for _ in up_convs:
                skip = skips.pop()
                x = run_strided(f"up_{c}/up", x)
                x = torch.cat([x, skip.to(dtype)], dim=-1)
                x = run_res_block(f"up_{c}/res", x)
                c //= 2
            x = run_conv("out_block/conv", x)
            logits = torch.matmul(x.to(torch.float32), proj_w) + proj_b
        return torch.softmax(logits, dim=-1)

    return forward
