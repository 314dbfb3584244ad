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

``stats=True`` is the measuring side of int8 calibration
(``models/quant_vnet.py:calibrate_int8``): the forward also returns each
activation site's ``max|a|`` under the JAX package's site keys.

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


def fold_net(net: SegmentationNet) -> dict:
    """Every site of ``net`` with BatchNorm folded in, as host numpy
    float32 under the JAX package's site keys:

    - 3^3 convs (``in_block/conv``, ``<level>/res/conv<j>``,
      ``out_block/conv``) and the strided sites (``down_<c>/down``,
      ``up_<c>/up``): ``{"w", "b", "alpha"}`` with ``w`` in DHWIO (output
      channel last). A transposed conv's ``w [2,2,2,Cin,Cout]`` gives
      output voxel ``2z+dz`` the product ``x[z] @ w[dz]``; its site also
      has ``"transpose": True``.
    - residual blocks (``<level>/res``): ``{"n", "alpha_out"}``;
    - ``out_block/proj``: ``{"w" [NC, NC] (in, out), "b"}``.
    """
    sd = {k: v.detach().to("cpu", torch.float32).numpy()
          for k, v in net.state_dict().items() if v.is_floating_point()}
    act_kind = net.act

    def alpha_of(prefix):
        key = f"{prefix}.alpha"
        return float(sd[key].reshape(-1)[0]) if act_kind == "prelu" else 0.25

    sites = {}

    def reg(key, prefix, conv, bn, act, perm, transpose=False):
        # a conv weight [O,I,k,k,k] / a transposed-conv weight [I,O,k,k,k]
        # -> DHWIO, folded over the output channel (last)
        w, b = fold_bn_np(sd[f"{prefix}.{conv}.weight"].transpose(perm),
                          sd.get(f"{prefix}.{conv}.bias"),
                          sd[f"{prefix}.{bn}.weight"], sd[f"{prefix}.{bn}.bias"],
                          sd[f"{prefix}.{bn}.running_mean"],
                          sd[f"{prefix}.{bn}.running_var"])
        sites[key] = {"w": w, "b": b, "alpha": alpha_of(f"{prefix}.{act}"),
                      "transpose": transpose}

    def reg_conv(key, prefix):
        reg(key, prefix, "conv", "bn", "act", (2, 3, 4, 1, 0))

    def reg_res_block(key, prefix, num_convs):
        for i in range(num_convs):
            reg_conv(f"{key}/conv{i}", f"{prefix}.conv{i}")
        sites[key] = {"n": num_convs, "alpha_out": alpha_of(f"{prefix}.act_out")}

    reg_conv("in_block/conv", "in_block.conv")
    c = net.base_channels
    for n in net.down_convs:
        c *= 2
        reg(f"down_{c}/down", f"down_{c}", "down_conv", "down_bn", "down_act",
            (2, 3, 4, 1, 0))
        reg_res_block(f"down_{c}/res", f"down_{c}.res", n)
    for n in net.up_convs:
        reg(f"up_{c}/up", f"up_{c}", "up_conv", "up_bn", "up_act",
            (2, 3, 4, 0, 1), transpose=True)
        reg_res_block(f"up_{c}/res", f"up_{c}.res", n)
        c //= 2
    reg_conv("out_block/conv", "out_block.conv")
    sites["out_block/proj"] = {"w": sd["out_block.proj.weight"][:, :, 0, 0, 0].T,
                               "b": sd["out_block.proj.bias"]}
    return sites


def build_fused_forward(net: SegmentationNet, dtype=torch.bfloat16,
                        stats: bool = False):
    """Fold ``net``'s weights (:func:`fold_net`) and return
    ``forward(x [B,D,H,W,Cin]) -> probabilities [B,D,H,W,NC]`` (float32)
    computing the same function as ``net`` in eval mode, within bf16
    tolerance. ``dtype`` is the activation type between layers (bf16 for
    inference; float32 for parity tests). The folded weights live where
    ``net``'s parameters are.

    ``stats=True``: ``forward`` returns ``(probabilities, {site: max|a|})``
    with ``a`` each site's activation after its act (a residual block's
    after its add): ``in_block/conv``, ``down_<c>/down``,
    ``down_<c>/res/conv<j>``, ``down_<c>/res``, ``up_<c>/up``, ...,
    ``out_block/conv``. Single-conv residual blocks then run their tail
    outside the kernel, which would otherwise hide the conv's own output."""
    if net.bottleneck:
        raise NotImplementedError("fused forward supports the standard "
                                  "(non-bottleneck) V-Net blocks")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dtype must be bfloat16 or float32, got {dtype}")
    device = next(net.parameters()).device
    act_kind = net.act

    def dev(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dt)

    sites = {}
    for key, f in fold_net(net).items():
        if "n" in f:
            sites[key] = f
        elif key == "out_block/proj":
            # bf16-rounded operands (under bf16), f32 accumulation
            proj_w = dev(f["w"], dtype).to(torch.float32)
            proj_b = dev(f["b"], torch.float32)
        elif key.endswith("/down") or key.endswith("/up"):
            # back to torch's [O,I,k,k,k] / transposed [I,O,k,k,k]
            inv = (3, 4, 0, 1, 2) if f["transpose"] else (4, 3, 0, 1, 2)
            sites[key] = {"w": dev(f["w"].transpose(inv), dtype),
                          "b": dev(f["b"], dtype), "alpha": f["alpha"],
                          "transpose": f["transpose"]}
        else:
            sites[key] = {"w": dev(f["w"], torch.bfloat16),
                          "b": dev(f["b"], torch.float32),
                          "alpha": f["alpha"], "res_alpha": None}
    for key, f in list(sites.items()):
        if f.get("n") == 1:
            # a single-conv block fuses act_out(x + .) into the conv
            sites[f"{key}/conv0"]["res_alpha"] = f["alpha_out"]

    st = {}

    def record(key, a):
        if stats:
            st[key] = torch.amax(torch.abs(a)).to(torch.float32)
        return a

    def run_conv(key, x):
        s = sites[key]
        fused_tail = s["res_alpha"] is not None and not stats
        return record(key, thin_conv3d(
            x, s["w"], s["b"], act=act_kind, alpha=s["alpha"], out_dtype=dtype,
            residual=act_kind if fused_tail else "none",
            res_alpha=s["res_alpha"] if fused_tail else 0.25))

    def run_strided(key, x):
        s = sites[key]
        if s["transpose"]:
            out = F.conv_transpose3d(_ncdhw(x), s["w"], stride=2)
        else:
            out = F.conv3d(_ncdhw(x), s["w"], stride=2)
        out = _ndhwc(out) + s["b"]
        return record(key, activation(out, act_kind, s["alpha"])).to(dtype)

    def run_res_block(key, x):
        s = sites[key]
        if s["n"] == 1 and not stats:
            return run_conv(f"{key}/conv0", x)
        h = x
        for i in range(s["n"]):
            h = run_conv(f"{key}/conv{i}", h)
        return record(key, activation(x + h, act_kind, s["alpha_out"])).to(dtype)

    down_convs, up_convs, base = net.down_convs, net.up_convs, net.base_channels

    @torch.inference_mode()
    def forward(x):
        st.clear()
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
        probs = torch.softmax(logits, dim=-1)
        if not stats:
            return probs
        # one device-to-host copy for all the sites' maxima
        values = torch.stack(list(st.values())).tolist()
        return probs, dict(zip(st, values))

    return forward
