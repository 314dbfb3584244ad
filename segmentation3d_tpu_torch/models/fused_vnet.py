"""Fused inference forward for V-Net and VB-Net: BN folded into every
conv, stride-1 3x3x3 convs through the hand-written kernel.

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

A bottleneck net (VB-Net, ``net.bottleneck``; the JAX package has no
folded form of it) has its own sites and run function for its chains:
each block's 1x1 ``reduce`` and ``expand`` (which takes the block's
BatchNorm) are GEMMs over the ``[voxels, C]`` view (``torch.addmm``, bias
in the GEMM, activation in place after it), its 3^3 conv goes through
:func:`thin_conv3d` (mid 8, 32 and 64 channels) or, where cuDNN is the
faster (mid 16), through cuDNN (:func:`_mid_on_cudnn`), and a chain ends
with ``act_out(x + h)``. The stem, the strided sites and the head are
V-Net's.

On a CUDA device the forward (not the ``stats`` one) is marked
``capturable``: :class:`..core.infer_engine.SlidingWindowInferer` replays it
from a CUDA graph.

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
from segmentation3d_tpu_torch.ops.conv_plan import uses_tensor_cores
from segmentation3d_tpu_torch.ops.thin_conv import (
    activation, fold_bn_np, thin_conv3d,
)
from segmentation3d_tpu_torch.utils.device import no_tf32

#: the activations the kernel's epilogue (and the folded forward) applies
FOLDED_ACTS = ("relu", "prelu")


def _ncdhw(x):
    """[B,D,H,W,C] -> a [B,C,D,H,W] view (channels_last_3d strides)."""
    return x.permute(0, 4, 1, 2, 3)


def _ndhwc(x):
    return x.permute(0, 2, 3, 4, 1).contiguous()


def _act_(x, kind, alpha):
    """:func:`activation` in place (prelu with one slope is leaky_relu)."""
    return torch.relu_(x) if kind == "relu" else F.leaky_relu_(x, alpha)


def _mid_on_cudnn(cin: int, cout: int) -> bool:
    """Whether a bottleneck block's 3^3 conv runs on cuDNN (conv, then bias
    and act) rather than :func:`thin_conv3d`: a site the kernel takes on
    its direct path (:func:`..ops.thin_conv.kernel_path`) with 16 or more
    input channels. On an H100 at 8 x 48^3 and 8 x 96^3 the direct path
    beats cuDNN at 8 channels (0.17 / 0.24 ms, 1.29 / 1.89 ms) and loses at
    16 (8 x 24^3: 0.089 / 0.053 ms, 8 x 48^3: 0.56 / 0.28 ms)."""
    return not uses_tensor_cores(cin, cout) and cin >= 16


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

    A bottleneck net's chains (``<level>/res``) are ``{"chain", "alpha_act",
    "alpha_out"}`` (``alpha_act``: the slopes of ``act<i>`` between its
    blocks), with each block's sites ``<level>/res/conv<j>/reduce``
    (1x1x1), ``.../conv`` (3^3) and ``.../expand`` (1x1x1, folded with the
    block's ``bn``; no activation, ``alpha`` None).
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
        sites[key] = {"w": w, "b": b,
                      "alpha": alpha_of(f"{prefix}.{act}") if act else None,
                      "transpose": transpose}

    def reg_conv(key, prefix):
        reg(key, prefix, "conv", "bn", "act", (2, 3, 4, 1, 0))

    def reg_res_block(key, prefix, num_convs):
        for i in range(num_convs):
            reg_conv(f"{key}/conv{i}", f"{prefix}.conv{i}")
        sites[key] = {"n": num_convs, "alpha_out": alpha_of(f"{prefix}.act_out")}

    def reg_chain(key, prefix, num_convs):
        for i in range(num_convs):
            reg(f"{key}/conv{i}/reduce", f"{prefix}.conv{i}.reduce", "conv", "bn",
                "act", (2, 3, 4, 1, 0))
            reg_conv(f"{key}/conv{i}/conv", f"{prefix}.conv{i}.conv")
            reg(f"{key}/conv{i}/expand", f"{prefix}.conv{i}", "expand", "bn", None,
                (2, 3, 4, 1, 0))
        sites[key] = {"chain": num_convs,
                      "alpha_act": [alpha_of(f"{prefix}.act{i}")
                                    for i in range(num_convs - 1)],
                      "alpha_out": alpha_of(f"{prefix}.act_out")}

    reg_block = reg_chain if net.bottleneck else reg_res_block
    reg_conv("in_block/conv", "in_block.conv")
    c = net.base_channels
    for n in net.down_convs:
        c *= 2
        reg(f"down_{c}/down", f"down_{c}", "down_conv", "down_bn", "down_act",
            (2, 3, 4, 1, 0))
        reg_block(f"down_{c}/res", f"down_{c}.res", n)
    for n in net.up_convs:
        reg(f"up_{c}/up", f"up_{c}", "up_conv", "up_bn", "up_act",
            (2, 3, 4, 0, 1), transpose=True)
        reg_block(f"up_{c}/res", f"up_{c}.res", n)
        c //= 2
    reg_conv("out_block/conv", "out_block.conv")
    sites["out_block/proj"] = {"w": sd["out_block.proj.weight"][:, :, 0, 0, 0].T,
                               "b": sd["out_block.proj.bias"]}
    return sites


def build_fused_forward(net: SegmentationNet, dtype=torch.bfloat16,
                        stats: bool = False):
    """Fold ``net``'s weights (:func:`fold_net`; standard or bottleneck
    blocks) and return ``forward(x [B,D,H,W,Cin]) -> probabilities
    [B,D,H,W,NC]`` (float32) computing the same function as ``net`` in eval
    mode, within bf16 tolerance. ``dtype`` is the activation type between
    layers (bf16 for inference; float32 for parity tests). The folded
    weights live where ``net``'s parameters are.

    ``stats=True``: ``forward`` returns ``(probabilities, {site: max|a|})``
    with ``a`` each site's activation after its act (a residual block's
    after its add): ``in_block/conv``, ``down_<c>/down``,
    ``down_<c>/res/conv<j>``, ``down_<c>/res``, ``up_<c>/up``, ...,
    ``out_block/conv``. Single-conv residual blocks then run their tail
    outside the kernel, which would otherwise hide the conv's own output.
    It measures the int8 forward's sites, so a bottleneck net refuses it."""
    if net.bottleneck and stats:
        raise NotImplementedError("stats=True measures the int8 forward's "
                                  "sites; it supports the standard "
                                  "(non-bottleneck) V-Net blocks")
    if net.act not in FOLDED_ACTS:
        # the JAX fused forward's _act has no leaky_relu either
        raise NotImplementedError(f"fused forward supports the activations "
                                  f"{FOLDED_ACTS}, not {net.act!r}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dtype must be bfloat16 or float32, got {dtype}")
    device = next(net.parameters()).device
    act_kind = net.act

    def dev(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dt)

    sites = {}
    for key, f in fold_net(net).items():
        if "n" in f or "chain" in f:
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
        elif f["w"].shape[:3] == (1, 1, 1):
            # a bottleneck block's reduce / expand: w [Cin, Cout] for addmm
            sites[key] = {"w": dev(f["w"][0, 0, 0], dtype),
                          "b": dev(f["b"], dtype), "alpha": f["alpha"]}
        elif net.bottleneck and "/res/" in key and \
                _mid_on_cudnn(*f["w"].shape[3:]):
            # torch's [O,I,3,3,3], channels-last as cuDNN reads it
            w = dev(f["w"].transpose(4, 3, 0, 1, 2), dtype)
            sites[key] = {"w": w.contiguous(memory_format=torch.channels_last_3d),
                          "b": dev(f["b"], dtype), "alpha": f["alpha"],
                          "cudnn": True}
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

    def gemm(key, x):
        s = sites[key]
        y = torch.addmm(s["b"], x.reshape(-1, x.shape[-1]), s["w"])
        return y.view(*x.shape[:-1], y.shape[-1])

    def run_mid(key, x):
        s = sites[key]
        if "cudnn" not in s:
            return run_conv(key, x)
        out = _ndhwc(F.conv3d(_ncdhw(x), s["w"], s["b"], padding=1))
        return _act_(out, act_kind, s["alpha"])

    def run_chain(key, x):
        s = sites[key]
        h = x
        for i in range(s["chain"]):
            site = f"{key}/conv{i}"
            h = _act_(gemm(f"{site}/reduce", h), act_kind,
                      sites[f"{site}/reduce"]["alpha"])
            h = gemm(f"{site}/expand", run_mid(f"{site}/conv", h))
            if i + 1 < s["chain"]:
                h = _act_(h, act_kind, s["alpha_act"][i])
        return _act_(h.add_(x), act_kind, s["alpha_out"])

    run_block = run_chain if net.bottleneck else run_res_block

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
                x = run_block(f"down_{c}/res", x)
                if i + 1 < len(down_convs):
                    skips.append(x)
            for _ in up_convs:
                skip = skips.pop()
                x = run_strided(f"up_{c}/up", x)
                x = torch.cat([x, skip.to(dtype)], dim=-1)
                x = run_block(f"up_{c}/res", x)
                c //= 2
            x = run_conv("out_block/conv", x)
            logits = torch.matmul(x.to(torch.float32), proj_w) + proj_b
        probs = torch.softmax(logits, dim=-1)
        if not stats:
            return probs
        # one device-to-host copy for all the sites' maxima
        values = torch.stack(list(st.values())).tolist()
        return probs, dict(zip(st, values))

    # fixed addresses, no host sync, no host-side state between calls: the
    # engine may replay a batch shape's forward from a CUDA graph
    forward.capturable = not stats and device.type == "cuda"
    return forward
