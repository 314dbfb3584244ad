#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``segmentation3d_tpu_torch``) on one
NVIDIA GPU:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: compiles the hand-written kernels (``csrc/thin_conv3d.cu``,
   ``csrc/window_conv_i8.cu``) with nvcc for sm_90a, one nvcc each, in
   parallel;
3. kernels: holds ``thin_conv3d`` against its plain PyTorch version at every
   conv site of the bf16 V-Net forward (96^3 patches, batch 8, full width)
   and at the int8 forward's stem, and ``window_conv_i8`` against its plain
   version at every int8 3^3 site of the int8 forward (int8 outputs must be
   exactly equal), each kernel also at one ragged wide site
   ([8, 37, 50, 61, 32] -> 32); times each kernel, its plain version, a
   cuDNN yardstick and the bound, and prints each site's design (wgmma or
   direct) and launch plan (box, stages, shared bytes, blocks);
4. main path: ``seg_infer --bf16 --partition_type SIZE`` on a seeded
   512x512x240 CT-like volume with a seeded full-width V-Net, counting the
   kernel's launches; then the same case through the float32 ``nn.Module``
   forward. The net's BatchNorm statistics are taken from phantom patches
   and its head is biased so that about half of the body is foreground, so
   the mask depends on the forward: the two masks must agree on >= 98% of
   voxels, with a foreground Dice and a largest probability gap within
   limits;
5. int8 main path: ``seg_infer --int8`` on the same case and net, counting
   both kernels' launches, then ``--int8`` and ``--int8 --int8_calib`` held
   against the float32 run as in 4.

Each phase prints one JSON line; any failed check exits nonzero. The last
lines are the kernel summary, and ``{"ok": true, "device": ...}``.

    python3 chip_smoke.py
"""
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_INT8_OPS = 1.979e15  # H100 SXM dense int8 tensor-core rate
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 rate
BATCH, PATCH = 8, 96
RAGGED_SHAPE = (37, 50, 61)  # a wide site whose boxes are ragged on every axis
AGREE_MIN = 0.98          # mask agreement with f32 (tests/test_pallas_conv.py, test_quant.py)
# foreground Dice and largest probability gap against the f32 run: about
# twice the gaps of a sound forward of this seeded case on an H100, 700 W
# (bf16: Dice 0.99994, gap 0.0078; int8: Dice 0.99945, gap 0.309;
# calibrated int8: Dice 0.99920, gap 0.062)
DICE_MIN = 0.9998
DPROB_MAX = 0.02
INT8_LIMITS = {"int8_prob": (0.998, 0.6), "int8_calib_prob": (0.998, 0.12)}
FG_BODY = (0.2, 0.8)      # foreground share of the body, f32 mask


class CheckFailed(Exception):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def gpu_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` launches (CUDA events,
    after one warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def launch_plan(path, dims, cin, cout, elem_bytes):
    """The kernel line's design and launch plan: box, stages, shared bytes
    and blocks of the wgmma path (``ops/conv_plan.py``), or the direct
    path's one thread per voxel."""
    from segmentation3d_tpu_torch.ops.conv_plan import plan_conv
    if path == "tensor_cores":
        return dict(design="wgmma",
                    plan=plan_conv(BATCH, *dims, cin, cout, elem_bytes).summary())
    vox = BATCH * dims[0] * dims[1] * dims[2]
    return dict(design="direct", plan=dict(threads_per_block=128,
                                           blocks=-(-vox // 128)))


def site_list():
    """Every thin_conv3d site of one bf16 forward of the default V-Net
    (base 16, down (1,2,3,3), up (3,3,2,1), 1 -> 2 classes) on a batch of
    96^3 patches: (name, spatial size, cin, cout, residual tail, launches
    per forward)."""
    s = PATCH
    return [
        ("stem", s, 1, 16, False, 1),
        ("down_32.res", s // 2, 32, 32, True, 1),
        ("down_64.res", s // 4, 64, 64, False, 2),
        ("down_128.res", s // 8, 128, 128, False, 3),
        ("down_256.res", s // 16, 256, 256, False, 3),
        ("up_256.res", s // 8, 256, 256, False, 3),
        ("up_128.res", s // 4, 128, 128, False, 3),
        ("up_64.res", s // 2, 64, 64, False, 2),
        ("up_32.res", s, 32, 32, True, 1),
        ("head", s, 32, 2, False, 1),
    ]


def phase_kernels(torch, tc):
    """Kernel vs plain version at the main path's site shapes, plus the
    epilogue variants (prelu, f32 out, int8 out)."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    cases = [dict(name=n, size=sz, cin=ci, cout=co, act="relu",
                  residual="relu" if res else "none", out=torch.bfloat16,
                  per_forward=k) for n, sz, ci, co, res, k in site_list()]
    cases += [
        dict(name="ragged wide", dims=RAGGED_SHAPE, cin=32, cout=32, act="relu",
             residual="relu", out=torch.bfloat16, per_forward=0),
        dict(name="prelu+prelu tail", size=PATCH // 2, cin=32, cout=32,
             act="prelu", residual="prelu", out=torch.bfloat16, per_forward=0),
        dict(name="f32 out", size=PATCH // 4, cin=64, cout=64, act="relu",
             residual="none", out=torch.float32, per_forward=0),
        dict(name="int8 out", size=PATCH // 2, cin=32, cout=32, act="relu",
             residual="relu", out=torch.int8, per_forward=0),
        # the int8 forward's stem: full-precision patch in, int8 out
        dict(name="stem int8 out", size=PATCH, cin=1, cout=16, act="relu",
             residual="none", out=torch.int8, per_forward=0),
    ]
    results = []
    for c in cases:
        dims = c.get("dims") or (c["size"],) * 3
        s, ci, co = max(dims), c["cin"], c["cout"]
        x = torch.randn(BATCH, *dims, ci, device=dev, generator=g)
        x = x.to(torch.bfloat16)
        w = (torch.randn(3, 3, 3, ci, co, device=dev, generator=g)
             * (2.0 / (27 * ci)) ** 0.5).to(torch.bfloat16)
        b = torch.randn(co, device=dev, generator=g) * 0.1
        q = 16.0 if c["out"] == torch.int8 else None
        kw = dict(act=c["act"], alpha=0.1, out_dtype=c["out"],
                  residual=c["residual"], res_alpha=0.2, quant_inv_sa=q)
        out = tc.thin_conv3d(x, w, b, **kw)
        ref = tc.thin_conv3d_reference(x, w, b, **kw)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        check(bool(torch.isfinite(out.float()).all()), f"{c['name']}: non-finite")
        if q is None:
            tol = 0.05 * float(ref.float().abs().max())
        else:
            # int8: one step at most, where the two accumulation orders put a
            # sum on opposite sides of a rounding midpoint; exact elsewhere
            tol = 1.0
            exact = float((out == ref).float().mean())
            check(exact > 0.99, f"{c['name']}: only {exact} of outputs exact")
        check(err <= tol, f"{c['name']}: max abs err {err} > tol {tol}")

        # cuDNN yardstick: F.conv3d in bf16 + bias + act (+ tail), NDHWC views
        w_lib = w.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
        b_lib = b.to(torch.bfloat16)
        x_lib = x.permute(0, 4, 1, 2, 3)

        def library():
            o = tc.activation(F.conv3d(x_lib, w_lib, b_lib, padding=1),
                              c["act"], 0.1)
            if c["residual"] != "none":
                o = tc.activation(o + x_lib, c["residual"], 0.2)
            if q is not None:
                return torch.clamp(torch.round(o.float() * q), -127, 127).to(torch.int8)
            return o.to(c["out"])

        reps = 20 if s <= PATCH // 2 else 10
        kernel_ms = cuda_ms(lambda: tc.thin_conv3d(x, w, b, **kw), reps)
        plain_ms = cuda_ms(lambda: tc.thin_conv3d_reference(x, w, b, **kw), 3)
        library_ms = cuda_ms(library, reps)
        vox = BATCH * dims[0] * dims[1] * dims[2]
        out_bytes = {torch.bfloat16: 2, torch.float32: 4, torch.int8: 1}[c["out"]]
        nbytes = vox * ci * 2 + vox * co * out_bytes + 27 * ci * co * 2 + co * 4
        flops = 2 * 27 * ci * co * vox
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
        r = dict(site=c["name"], shape=[BATCH, *dims, ci], cout=co,
                 act=c["act"], residual=c["residual"],
                 out=str(c["out"]).replace("torch.", ""),
                 path=tc.kernel_path(ci, co), per_forward=c["per_forward"],
                 **launch_plan(tc.kernel_path(ci, co), dims, ci, co, 2),
                 max_abs_err=err, tol=tol, kernel_ms=kernel_ms,
                 plain_ms=plain_ms, library_ms=library_ms,
                 bound_ms=max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations",
                 flops=flops, bytes=nbytes,
                 tflops=flops / kernel_ms / 1e9)
        emit("kernel", **r)
        results.append(r)
        del x, w, out, ref
        torch.cuda.empty_cache()
    return results


def phantom_hu(z, y, x, rng):
    """A CT-like int16 volume sampled at the millimetre coordinates ``z``,
    ``y``, ``x`` (1-D, 0 at the centre): air at -1000 HU, an elliptic body
    (soft tissue inside a fat ring, 60% and 40% of it), organs, a spine,
    noise."""
    import numpy as np
    zz, yy, xx = np.meshgrid(z, y, x, indexing="ij", sparse=True)
    body2d = ((xx / 160.0) ** 2 + (yy / 110.0) ** 2)[0]
    img = np.full((len(z), len(y), len(x)), -1000, np.int16)
    img[:, body2d < 1.0] = -100
    img[:, body2d < 0.6] = 40
    for (cz, cy, cx, r, hu) in [(0, -20, 60, 45, 60), (30, 10, -70, 35, 150),
                                (-40, 30, 0, 25, -600), (60, -30, -20, 20, 200)]:
        img[((zz - cz) ** 2 + (yy - cy) ** 2 + (xx - cx) ** 2) < r * r] = hu
    spine = ((yy - 70) ** 2 + xx ** 2) < 15 ** 2
    img[np.broadcast_to(spine, img.shape)] = 700
    img += rng.normal(0, 20, img.shape).astype(np.int16)
    return img


def make_ct(path, seed=0):
    """Write the phantom as a 512x512x240 int16 volume at 0.7x0.7x1.25 mm;
    returns its voxels (z, y, x)."""
    import numpy as np
    from segmentation3d_tpu_torch.io import Volume, write_image
    from segmentation3d_tpu_torch.ops.geometry import Frame
    sp = np.array([0.7, 0.7, 1.25])  # x, y, z
    z, y, x = ((np.arange(n) - n / 2) * d for n, d in
               ((240, sp[2]), (512, sp[1]), (512, sp[0])))
    img = phantom_hu(z, y, x, np.random.default_rng(seed))
    write_image(Volume(img, Frame.identity(spacing=sp)), path)
    return img


def seeded_vnet(torch, seed=0):
    """Full-width V-Net (base 16, 1 -> 2 classes) with seeded weights and
    non-trivial BatchNorm statistics, from an explicit torch.Generator."""
    from segmentation3d_tpu_torch.models.vnet import SegmentationNet
    net = SegmentationNet(in_channels=1, out_channels=2)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in list(net.named_parameters()) + list(net.named_buffers()):
            if name.endswith("num_batches_tracked"):
                continue
            if name.endswith(".alpha"):
                t.fill_(0.25)
            elif name.endswith("weight") and t.dim() == 5:
                # a 2^3/s2 transposed conv feeds each output from one tap
                fan_in = t.shape[0] if "up_conv" in name \
                    else t.shape[1] * t[0, 0].numel()
                t.copy_(torch.randn(t.shape, generator=g) * (2.0 / fan_in) ** 0.5)
            elif "bn" in name and name.endswith("weight"):
                t.copy_(torch.rand(t.shape, generator=g) * 0.5 + 0.75)
            elif name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=g) * 0.5 + 0.75)
            elif name.endswith("running_mean") or name.endswith("bias"):
                t.copy_(torch.randn(t.shape, generator=g) * 0.1)
    return net


def calibrate(torch, net, normalizer, seed=1):
    """Give ``net`` the BatchNorm statistics of two seeded 96^3 phantom
    patches at 1 mm (one inside the body, one across its edge), as training
    would leave them, and fit its head conv to the patches' soft tissue (HU
    above -30: muscle, organs, bone; not fat, lung or air) by one
    least-squares solve over its 3^3 x 32 inputs at 60,000 body voxels, as
    a trained head separates its classes with a margin. A random head
    leaves most voxels at one constant logit, so a mask check on it is
    vacuous; a random head biased to its median log-odds puts the decision
    boundary in the densest part of the body, where the int8 forward's own
    rounding flips a few percent of the voxels."""
    import numpy as np
    import torch.nn.functional as F
    rng = np.random.default_rng(seed)
    mm = np.arange(96) + 0.5
    hu = np.stack([phantom_hu(mm - 48, mm - 60, mm + 20, rng),
                   phantom_hu(mm - 48, mm + 40, mm - 48, rng)])
    x = normalizer(torch.from_numpy(hu))[..., None]
    for m in net.modules():
        if isinstance(m, torch.nn.BatchNorm3d):
            m.reset_running_stats()
            m.momentum = None  # one pass: the running stats are the batch's
    net.train()
    with torch.no_grad():
        net(x)
    net.eval()
    head = net.out_block
    feats = []
    hook = head.conv.register_forward_hook(lambda m, i, o: feats.append(i[0]))
    with torch.no_grad():
        net(x)
    hook.remove()
    # the head conv's input [N, 32, D, H, W] at sampled body voxels, tap by
    # tap; fitted on the body only, as air would pull a near-linear fit
    # towards putting fat on the soft-tissue side
    f = F.pad(feats[0], (1, 1, 1, 1, 1, 1))
    vox = torch.nonzero(torch.from_numpy(hu > -500))
    g = torch.Generator().manual_seed(seed)
    n, z, y, xx = vox[torch.randperm(len(vox), generator=g)[:60000]].T
    a = torch.cat([f[n, :, z + dz, y + dy, xx + dx] for dz in range(3)
                   for dy in range(3) for dx in range(3)], dim=1).double()
    a = torch.cat([a, torch.ones(len(a), 1, dtype=a.dtype)], dim=1)
    target = torch.from_numpy(hu > -30)[n, z, y, xx].double() * 2 - 1
    coef = torch.linalg.solve(a.T @ a, a.T @ target).float()
    w = coef[:-1].view(3, 3, 3, -1).permute(3, 0, 1, 2)
    with torch.no_grad():
        # channel 1 is q = w * f + b, channel 0 is -q; BN is the identity
        # plus 1, so relu keeps the sign of q and the log-odds
        # 0.5 * (relu(1 + q) - relu(1 - q)) are q where |q| <= 1
        conv, bn = head.conv.conv, head.conv.bn
        conv.weight.copy_(torch.stack([-w, w]))
        conv.bias.copy_(torch.stack([-coef[-1], coef[-1]]))
        bn.running_mean.zero_()
        bn.running_var.fill_(1.0 - bn.eps)
        bn.weight.fill_(1.0)
        bn.bias.fill_(1.0)
        head.proj.weight.copy_(0.5 * torch.eye(2).view(2, 2, 1, 1, 1))
        head.proj.bias.zero_()
    return net


def site_list_i8():
    """Every window_conv_i8 site of one int8 forward of the default V-Net on
    a batch of 96^3 patches: (name, spatial size, cin, cout, residual
    identity, output, launches per forward). A single-conv residual block's
    conv carries its tail with its own input as the identity; the others
    run without one (the last conv of a multi-conv chain reads the block
    input as its identity: the "multi-conv tail" variant)."""
    s = PATCH
    return [
        ("down_32.res", s // 2, 32, 32, "same", "int8", 1),
        ("down_64.res", s // 4, 64, 64, None, "int8", 2),
        ("down_128.res", s // 8, 128, 128, None, "int8", 3),
        ("down_256.res", s // 16, 256, 256, None, "int8", 3),
        ("up_256.res", s // 8, 256, 256, None, "int8", 3),
        ("up_128.res", s // 4, 128, 128, None, "int8", 3),
        ("up_64.res", s // 2, 64, 64, None, "int8", 2),
        ("up_32.res", s, 32, 32, "same", "int8", 1),
        ("head", s, 32, 2, None, "bf16", 1),
    ]


def phase_kernels_i8(torch, wi):
    """window_conv_i8 vs its plain version at the int8 forward's site
    shapes, plus a multi-conv tail (separate identity) and a prelu variant.
    int8 outputs must be exactly equal, the bf16 head within one step."""
    import torch.nn.functional as F
    from segmentation3d_tpu_torch.ops.quant import requant
    from segmentation3d_tpu_torch.ops.thin_conv import activation
    g = torch.Generator(device="cuda").manual_seed(2)
    dev = torch.device("cuda")
    cases = [dict(name=n, size=sz, cin=ci, cout=co, ident=t, out=o, act="relu",
                  per_forward=k) for n, sz, ci, co, t, o, k in site_list_i8()]
    cases += [
        dict(name="ragged wide", dims=RAGGED_SHAPE, cin=32, cout=32,
             ident="same", out="int8", act="relu", per_forward=0),
        dict(name="multi-conv tail (separate identity)", size=PATCH // 4,
             cin=64, cout=64, ident="separate", out="int8", act="relu",
             per_forward=0),
        dict(name="prelu + prelu tail", size=PATCH // 2, cin=32, cout=32,
             ident="same", out="int8", act="prelu", per_forward=0),
    ]

    def ints(shape):
        return torch.randint(-127, 128, shape, device=dev, generator=g,
                             dtype=torch.int16).to(torch.int8)

    results = []
    for c in cases:
        dims = c.get("dims") or (c["size"],) * 3
        s, ci, co, act = max(dims), c["cin"], c["cout"], c["act"]
        x = ints((BATCH, *dims, ci))
        w = ints((3, 3, 3, ci, co))
        # dequant so that the activations spread over the int8 range
        scale = (torch.rand(co, device=dev, generator=g) + 0.5) \
            / (127.0 * 127.0 * 3 * ci ** 0.5)
        bias = torch.randn(co, device=dev, generator=g) * 0.5
        ident = {"same": x, "separate": ints((BATCH, *dims, co)),
                 None: None}[c["ident"]]
        int8 = c["out"] == "int8"
        kw = dict(out=c["out"], inv_out=127.0 / 6.0 if int8 else None,
                  identity=ident, s_id=5.0 / 127.0 if ident is not None else None,
                  res_act=act if ident is not None else "none", res_alpha=0.2)
        out = wi.window_conv_i8(x, w, scale, bias, act, 0.1, **kw)
        ref = wi.window_conv_i8_reference(x, w, scale, bias, act, 0.1, **kw)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        check(bool(torch.isfinite(out.float()).all()), f"{c['name']}: non-finite")
        live = float((out != 0).float().mean())
        check(live > 0.05, f"{c['name']}: only {live} of outputs nonzero")
        if int8:
            # any difference means the epilogue's order or rounding differs
            tol = 0.0
            check(torch.equal(out, ref), f"{c['name']}: int8 output differs "
                  f"from the plain version (max abs err {err})")
        else:
            tol = float((ref.float().abs() * 2.0 ** -8).max())
            d = (out.float() - ref.float()).abs() <= ref.float().abs() * 2.0 ** -8
            check(bool(d.all()), f"{c['name']}: more than one bf16 step off")

        # cuDNN yardstick: PyTorch has no int8 3D conv on CUDA, so F.conv3d
        # in bf16 on the same integer values, plus the same epilogue
        w_lib = w.to(torch.bfloat16).permute(4, 3, 0, 1, 2).contiguous(
            memory_format=torch.channels_last_3d)
        sv, bv = scale.view(1, -1, 1, 1, 1), bias.view(1, -1, 1, 1, 1)
        id_lib = ident.permute(0, 4, 1, 2, 3) if ident is not None else None

        def library():
            a = F.conv3d(x.permute(0, 4, 1, 2, 3).to(torch.bfloat16), w_lib,
                         padding=1).float()
            a = activation(a * sv + bv, act, 0.1)
            if id_lib is not None:
                a = activation(id_lib.float() * (5.0 / 127.0) + a, act, 0.2)
            return requant(a, 127.0 / 6.0) if int8 else a.to(torch.bfloat16)

        reps = 20 if s <= PATCH // 2 else 10
        kernel_ms = cuda_ms(lambda: wi.window_conv_i8(x, w, scale, bias, act,
                                                      0.1, **kw), reps)
        plain_ms = cuda_ms(lambda: wi.window_conv_i8_reference(
            x, w, scale, bias, act, 0.1, **kw), 2)
        library_ms = cuda_ms(library, reps)
        vox = BATCH * dims[0] * dims[1] * dims[2]
        out_bytes = 1 if int8 else 2
        nbytes = vox * ci + vox * co * out_bytes + 27 * ci * co + 8 * co
        if c["ident"] == "separate":
            nbytes += vox * co
        ops = 2 * 27 * ci * co * vox
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_INT8_OPS * 1e3
        r = dict(site=c["name"], shape=[BATCH, *dims, ci], cout=co, act=act,
                 identity=c["ident"], out=c["out"],
                 path=wi.kernel_path(ci, co), per_forward=c["per_forward"],
                 **launch_plan(wi.kernel_path(ci, co), dims, ci, co, 1),
                 max_abs_err=err, tol=tol, kernel_ms=kernel_ms,
                 plain_ms=plain_ms, library_ms=library_ms,
                 bound_ms=max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations",
                 ops=ops, bytes=nbytes, tops=ops / kernel_ms / 1e9)
        emit("kernel_i8", **r)
        results.append(r)
        del x, w, ident, out, ref, w_lib, id_lib
        torch.cuda.empty_cache()
    return results


def mask_gaps(np, read_image, a, b, body):
    """Agreement, foreground Dice, largest probability gap and the
    foreground share of the body (of ``a``'s mask) between two runs that
    saved their probabilities."""
    dprob = 0.0
    for c in range(2):
        pa = read_image(os.path.join(a["out"], f"prob_{c}.mha")).data
        pb = read_image(os.path.join(b["out"], f"prob_{c}.mha")).data
        check(bool(np.isfinite(pa).all() and np.isfinite(pb).all()),
              "non-finite probabilities")
        dprob = max(dprob, float(np.abs(pa - pb).max()))
    fg = [r["mask"] == 1 for r in (a, b)]
    return dict(
        agreement=float(np.mean(a["mask"] == b["mask"])),
        foreground_dice=float(2 * np.sum(fg[0] & fg[1])
                              / max(1, np.sum(fg[0]) + np.sum(fg[1]))),
        max_abs_dprob=dprob, foreground_fraction_of_body=float(np.mean(fg[0][body])),
        foreground_fraction=float(np.mean(fg[0])))


def phase_main(torch, tc, workdir, gpu):
    import numpy as np
    from segmentation3d_tpu_torch.cli.seg_infer import main as seg_infer
    from segmentation3d_tpu_torch.io import read_image
    from segmentation3d_tpu_torch.utils.model_io import save_checkpoint
    from segmentation3d_tpu_torch.utils.normalizer import FixedNormalizer

    t = time.perf_counter()
    norm = FixedNormalizer(40.0, 400.0, True)
    net = calibrate(torch, seeded_vnet(torch), norm)
    model_dir = os.path.join(workdir, "model")
    save_checkpoint(model_dir, 1, 0, net.state_dict(), "vnet", 16, 1, 2,
                    [1.0, 1.0, 1.0], "LINEAR", [norm])
    ct = os.path.join(workdir, "ct.nii.gz")
    hu = make_ct(ct)
    body = hu > -500
    shape = hu.shape
    del hu
    emit("setup", seconds=time.perf_counter() - t, volume_zyx=list(shape),
         spacing_xyz=[0.7, 0.7, 1.25])

    part = ["--partition_type", "SIZE", "--partition_size", "96", "96", "96",
            "--partition_stride", "64", "64", "64"]

    def run(tag, extra):
        out = os.path.join(workdir, tag)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = seg_infer(["-i", ct, "-m", model_dir, "-o", out] + part + extra)
        wall = time.perf_counter() - t0
        check(len(res) == 1, f"{tag}: expected one segmented case, got {res}")
        name, secs, stages = res[0]
        mask = read_image(os.path.join(out, name, "seg.mha")).data
        check(mask.shape == shape, f"{tag}: mask shape {mask.shape} != {shape}")
        check(mask.dtype == np.uint8 and int(mask.max()) < 2,
              f"{tag}: labels outside [0, 2)")
        return dict(tag=tag, out=os.path.join(out, name), mask=mask, wall=wall,
                    stages=stages, peak=torch.cuda.max_memory_allocated())

    # the main path: counts reset just before, read just after
    tc.thin_conv3d.launches = 0
    first = run("bf16", ["--bf16"])
    launches = tc.thin_conv3d.launches
    n_boxes = 6 * 6 * 5  # 384x384x320 iso grid, 96^3 boxes at stride 64
    n_batches = -(-n_boxes // BATCH)
    check(launches == 20 * n_batches,
          f"thin_conv3d launched {launches} times, expected 20 x {n_batches}")
    second = run("bf16_again", ["--bf16"])
    for r in (first, second):
        emit("main_path", run=r["tag"], launches=launches if r is first else None,
             patch_batches=n_batches, seconds=r["wall"], stages=r["stages"],
             volumes_per_min=60.0 / r["wall"],
             max_memory_allocated=r["peak"], gpu=gpu)

    bf16 = run("bf16_prob", ["--bf16", "--save_prob"])
    f32 = run("f32_prob", ["--save_prob"])
    gaps = mask_gaps(np, read_image, bf16, f32, body)
    agree, dice, dprob = (gaps[k] for k in ("agreement", "foreground_dice",
                                            "max_abs_dprob"))
    fg_body = float(np.mean((f32["mask"] == 1)[body]))
    emit("bf16_vs_f32", agreement=agree, min_agreement=AGREE_MIN,
         foreground_dice=dice, min_dice=DICE_MIN,
         max_abs_dprob=dprob, max_dprob=DPROB_MAX,
         foreground_fraction_bf16=gaps["foreground_fraction"],
         foreground_fraction_f32=float(np.mean(f32["mask"] == 1)),
         foreground_fraction_of_body_f32=fg_body, body_fraction=float(np.mean(body)),
         f32_seconds=f32["wall"], f32_stages=f32["stages"], gpu=gpu)
    check(FG_BODY[0] <= fg_body <= FG_BODY[1],
          f"f32 foreground is {fg_body} of the body, outside {FG_BODY}")
    check(agree >= AGREE_MIN, f"bf16/f32 agreement {agree} < {AGREE_MIN}")
    check(dice >= DICE_MIN, f"bf16/f32 foreground Dice {dice} < {DICE_MIN}")
    check(dprob <= DPROB_MAX, f"bf16/f32 max |dprob| {dprob} > {DPROB_MAX}")
    return dict(launches=launches, run=run, f32=f32, body=body, ct=ct,
                n_batches=n_batches)


def phase_main_int8(torch, tc, wi, ctx, gpu):
    """``seg_infer --int8`` on the main path's case: both kernels' launches,
    warm volumes/min, then int8 and calibrated int8 vs the float32 run."""
    import numpy as np
    from segmentation3d_tpu_torch.io import read_image
    run, n_batches = ctx["run"], ctx["n_batches"]
    # the int8 main path: counts reset just before, read just after
    tc.thin_conv3d.launches = 0
    wi.window_conv_i8.launches = 0
    first = run("int8", ["--int8"])
    launches = (tc.thin_conv3d.launches, wi.window_conv_i8.launches)
    check(launches == (n_batches, 19 * n_batches),
          f"int8 path launched (thin_conv3d, window_conv_i8) {launches}, "
          f"expected ({n_batches}, 19 x {n_batches})")
    second = run("int8_again", ["--int8"])
    for r in (first, second):
        emit("main_path_int8", run=r["tag"],
             launches=dict(thin_conv3d=launches[0], window_conv_i8=launches[1])
             if r is first else None,
             patch_batches=n_batches, seconds=r["wall"], stages=r["stages"],
             volumes_per_min=60.0 / r["wall"],
             max_memory_allocated=r["peak"], gpu=gpu)
    for tag, extra in (("int8_prob", []),
                       ("int8_calib_prob", ["--int8_calib", ctx["ct"]])):
        r = run(tag, ["--int8", "--save_prob"] + extra)
        gaps = mask_gaps(np, read_image, r, ctx["f32"], ctx["body"])
        dice_min, dprob_max = INT8_LIMITS[tag]
        emit("int8_vs_f32", run=tag, **gaps, min_agreement=AGREE_MIN,
             min_dice=dice_min, max_dprob=dprob_max,
             seconds=r["wall"], stages=r["stages"], gpu=gpu)
        fg_body = gaps["foreground_fraction_of_body"]
        check(FG_BODY[0] <= fg_body <= FG_BODY[1],
              f"{tag}: foreground is {fg_body} of the body, outside {FG_BODY}")
        check(gaps["agreement"] >= AGREE_MIN,
              f"{tag}/f32 agreement {gaps['agreement']} < {AGREE_MIN}")
        check(gaps["foreground_dice"] >= dice_min,
              f"{tag}/f32 foreground Dice {gaps['foreground_dice']} < {dice_min}")
        check(gaps["max_abs_dprob"] <= dprob_max,
              f"{tag}/f32 max |dprob| {gaps['max_abs_dprob']} > {dprob_max}")
    return launches[1]


def kernel_entry(name, source, replaces, launches, rows, peak_ops, ops_key):
    """One kernel's entry of the summary line: its per-site rows summed over
    one forward of a batch of 8 96^3 patches (each row times its launches
    per forward); ``ops_key`` names the rows' operation count."""
    fwd = [r for r in rows if r["per_forward"]]

    def per_forward(key):
        return sum(r[key] * r["per_forward"] for r in fwd)

    t_bytes = sum(r["bytes"] * r["per_forward"] for r in fwd) / PEAK_BYTES
    t_ops = sum(r[ops_key] * r["per_forward"] for r in fwd) / peak_ops
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in fwd),
            "ms": per_forward("kernel_ms"), "plain_ms": per_forward("plain_ms"),
            "bound_ms": per_forward("bound_ms"),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": per_forward("library_ms")}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "segmentation3d_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from segmentation3d_tpu_torch.ops import cuda_build
    from segmentation3d_tpu_torch.ops import thin_conv as tc
    from segmentation3d_tpu_torch.ops import window_i8 as wi

    gpu = gpu_line()
    emit("device", gpu=gpu, torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    t = time.perf_counter()
    libs = cuda_build.build_all()
    check(set(libs) >= {"thin_conv3d", "window_conv_i8"}, f"built {sorted(libs)}")
    emit("build", seconds=time.perf_counter() - t,
         libraries={n: os.path.relpath(p, HERE) for n, p in libs.items()})

    sites = phase_kernels(torch, tc)
    sites_i8 = phase_kernels_i8(torch, wi)
    with tempfile.TemporaryDirectory() as workdir:
        ctx = phase_main(torch, tc, workdir, gpu)
        launches_i8 = phase_main_int8(torch, tc, wi, ctx, gpu)

    print(gpu)
    print(json.dumps({"kernels": [
        # the bf16 main path's 20 launches per forward; the epilogue
        # variants' errors (int8 in steps) are on their own "kernel" lines
        kernel_entry("thin_conv3d", "segmentation3d_tpu_torch/csrc/thin_conv3d.cu",
                     "segmentation3d_tpu/ops/pallas_conv.py:174",
                     ctx["launches"], sites, PEAK_BF16_FLOPS, "flops"),
        # the int8 main path's 19 launches per forward
        kernel_entry("window_conv_i8",
                     "segmentation3d_tpu_torch/csrc/window_conv_i8.cu",
                     "segmentation3d_tpu/ops/pallas_i8win.py:144",
                     launches_i8, sites_i8, PEAK_INT8_OPS, "ops"),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
