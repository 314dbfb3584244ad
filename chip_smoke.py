#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``segmentation3d_tpu_torch``) on one
NVIDIA GPU:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: compiles the hand-written kernels (``csrc/thin_conv3d.cu``,
   ``csrc/window_conv_i8.cu``) with nvcc for sm_90a, one nvcc each, in
   parallel;
3. kernels: holds ``thin_conv3d`` against its plain PyTorch version at every
   conv site of the bf16 V-Net forward (96^3 patches, batch 8, full width)
   and at the int8 forward's stem, at the coarse-to-fine coarse pass's sites
   (batch 1), on a flipped batch, and at the sites of the train phase's
   validation forward (one 240x224x224 patch) and at up_32 of a whole
   256^3 volume and of a 64x512x512 slab, and ``window_conv_i8`` against its plain
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
5. formats: the same case written as a DICOM series of 240 uncompressed
   files and as a gzipped ``.nrrd`` reads to the NIfTI voxels exactly (the
   frames within 1e-6); ``seg_infer --bf16`` on each launches
   ``thin_conv3d`` 20 times per batch and gives 4's mask on >= 99.9% of
   voxels; a 16-slice slab written as an RLE and as a JPEG Lossless series
   reads back exactly (decode ms per slice; the native JPEG scan decode
   equals the Python loop on one slice); ``seg_eval`` scores both masks
   against 4's (foreground Dice >= 0.999). The host codec (``g++``) is
   built before any phase and its build (libdeflate or zlib-only) printed;
6. int8 main path: ``seg_infer --int8`` on the same case and net, counting
   both kernels' launches, then ``--int8`` and ``--int8 --int8_calib`` held
   against the float32 run as in 4;
7. pipeline: ``--bf16`` over a folder of three cases (the main case, a
   second seed, a 512x512x160 case) through the pipelined case loop; the
   main case's mask must equal 4's, and volumes/min over the batch is
   printed beside the single case's and the read-ahead's decode threads;
8. shard: several shards on the one card (a device list that repeats
   ``cuda:0``): ``segmentation`` with 2 patch shards, bf16 and ``--int8``
   (masks on >= 99.999% of 4's and 6's voxels; each engine's probabilities
   within 1e-5 of its unsharded run's; 20 launches per batch), spatial
   sharding of SLAB 64/48 over 1, 2 and 8 shards (masks equal, probabilities
   within 1e-5; each on >= 99.9% of the unsharded SLAB engine's voxels; 20
   launches per slab; peak memory per shard count), the CLI's
   ``--num_devices -1`` (4's mask) and its ``--spatial_shard`` refusal on
   one card, and two ``seg_infer`` processes in a gloo group over 7's
   folder (each case once, masks equal to 7's);
9. ensemble: ``-m a -m b --bf16`` against the float32 ensemble, and
   ``-m a -m a`` against 4's mask;
10. tta: ``--bf16 --tta all`` against float32 ``--tta all``;
11. c2f: ``--fine_model`` with a seeded 4 mm coarse net, ``--bf16`` and
   ``--int8`` against float32;
12. vbnet: a seeded full-width VB-Net, ``--bf16`` (its BN-folded forward, 16
   thin_conv3d launches a batch) against float32;
13. convert: 4's model written as the original PyTorch toolkit saves it
   (foreign names, no ``_kernel_layouts``); ``seg_infer --bf16`` through
   the positional importer, and on ``seg_convert``'s output, must each give
   4's mask voxel for voxel with 20 launches per batch; the import's and
   the conversion's seconds;
14. serve: ``seg_serve``'s ``main`` in a thread on a Unix socket, session
   caches emptied first: a bf16 server answers a ping, a burst of 7's three
   cases from three client threads (masks equal to 7's; a ping sent while
   the first runs answers before it ends; 20 launches per batch; model load
   and forward build once; at most one request prepared ahead) and one
   warm request; an int8 server calibrated on 4's case answers two
   requests (calibration once; masks equal to 6's calibrated mask); a
   coarse-to-fine server one (11's bf16 mask); each request's seconds, the
   burst's volumes/min beside 7's and peak device memory;
15. train_step: one SGD step of a seeded full-width V-Net on a seeded
   2 x 64^3 batch on the card and on the CPU, in float32 (TF32 off) and in
   float64 (loss, every update, every BatchNorm buffer), then the median step time at
   8 x 96^3 in float32 and bf16 beside its bound (the forward's operations
   by forward hooks, equal to ``utils/flops.py:vnet_forward_flops``);
16. train: ``seg_train`` on four seeded CT-like 256x256x160 cases with a
   two-organ label and one validation case (bf16, batch 8 x 96^3, 32
   steps, two save points): the loss falls, ``thin_conv3d`` launches 20
   times per validation forward and ``window_conv_i8`` never, the folded
   forward's val Dice is the float32 module's within a bar, ``chk_best``
   and the last checkpoint run through ``seg_infer --bf16``; crops/s, the
   prefetch-wait share, peak memory and seconds per save point;
17. train_ddp: two training ranks on the one card over gloo (this process
   is rank 0, a helper process rank 1; the backend rule and each rank's
   device printed): (a) one SGD step of the full-width V-Net, data 2, global
   batch 8 x 96^3, and (b) spatial 2, global batch 4 x 96^3 (48 planes per
   rank), each in float32 against the one-rank step at full size and in
   float64 at 64^3 (loss, running statistics, every update; both ranks end
   equal), with each rank's bf16 step ms beside the same ranks' steps
   without collectives; (c) ``seg_train`` as two torchrun ranks on 16's
   cases, 8 steps, two save points: one ``train_loss.csv`` and checkpoint
   (keys equal to 16's), ``thin_conv3d`` launched 20 times per validation
   forward on rank 0, each launch held against its plain version; each
   rank's step ms, crops/s for the pair, peak memory per rank.

Every path's kernel launches are counted from zero around its run and
checked against its batches.

Each phase prints one JSON line; any failed check exits nonzero. The last
lines are the kernel summary, and ``{"ok": true, "device": ...}``.

    python3 chip_smoke.py

(``python3 chip_smoke.py --train-only`` builds the kernels and runs 16 and
17 alone, for work on the training path; it prints no summary.)
"""
import datetime
import json
import math
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
#: the train phase's validation case (256 x 256 x 160 at 0.8 x 0.8 x 1.5 mm)
#: on its 1 mm grid padded to the 32-voxel shape bucket, z y x: one patch
VAL_DIMS = (240, 224, 224)
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


def launch_plan(path, dims, cin, cout, elem_bytes, batch=BATCH):
    """The kernel line's design and launch plan: box, stages, shared bytes
    and blocks of the wgmma path (``ops/conv_plan.py``), or the direct
    path's one thread per voxel."""
    from segmentation3d_tpu_torch.ops.conv_plan import plan_conv
    if path == "tensor_cores":
        return dict(design="wgmma",
                    plan=plan_conv(batch, *dims, cin, cout, elem_bytes).summary())
    vox = batch * dims[0] * dims[1] * dims[2]
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
    epilogue variants (prelu, f32 out, int8 out), the coarse-to-fine coarse
    pass's sites (one 96^3 grid at batch 1) and a flipped batch (TTA)."""
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
        # a batch flipped in z and x, as --tta feeds the forward
        dict(name="up_32.res flipped (TTA)", size=PATCH, cin=32, cout=32,
             act="relu", residual="relu", out=torch.bfloat16, per_forward=0,
             flip=(1, 3)),
    ]
    cases += [dict(name=f"coarse {n}", size=sz, cin=ci, cout=co, act="relu",
                   residual="relu" if res else "none", out=torch.bfloat16,
                   per_forward=0, batch=1, per_coarse_forward=k)
              for n, sz, ci, co, res, k in site_list()]
    # in-training validation: the train phase's case as one whole-volume
    # patch, and the largest patches validation gives the kernel (a whole
    # 256^3 volume, a 64-plane slab of a 512 x 512 volume)
    cases += [dict(name=f"validation {n}",
                   dims=tuple(d * sz // PATCH for d in VAL_DIMS), cin=ci, cout=co,
                   act="relu", residual="relu" if res else "none",
                   out=torch.bfloat16, per_forward=0, batch=1, per_val_forward=k)
              for n, sz, ci, co, res, k in site_list()]
    cases += [dict(name=f"validation {tag} up_32.res", dims=dims, cin=32, cout=32,
                   act="relu", residual="relu", out=torch.bfloat16,
                   per_forward=0, batch=1)
              for tag, dims in (("whole 256^3", (256, 256, 256)),
                                ("slab 64x512x512", (64, 512, 512)))]
    results = []
    for c in cases:
        dims = c.get("dims") or (c["size"],) * 3
        s, ci, co, nb = max(dims), c["cin"], c["cout"], c.get("batch", BATCH)
        x = torch.randn(nb, *dims, ci, device=dev, generator=g)
        if c.get("flip"):
            x = torch.flip(x, c["flip"])
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

        reps = 20 if s <= PATCH // 2 or nb == 1 else 10
        kernel_ms = cuda_ms(lambda: tc.thin_conv3d(x, w, b, **kw), reps)
        plain_ms = cuda_ms(lambda: tc.thin_conv3d_reference(x, w, b, **kw), 3)
        library_ms = cuda_ms(library, reps)
        vox = nb * dims[0] * dims[1] * dims[2]
        out_bytes = {torch.bfloat16: 2, torch.float32: 4, torch.int8: 1}[c["out"]]
        nbytes = vox * ci * 2 + vox * co * out_bytes + 27 * ci * co * 2 + co * 4
        flops = 2 * 27 * ci * co * vox
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
        r = dict(site=c["name"], shape=[nb, *dims, ci], cout=co,
                 act=c["act"], residual=c["residual"],
                 out=str(c["out"]).replace("torch.", ""),
                 path=tc.kernel_path(ci, co), per_forward=c["per_forward"],
                 per_coarse_forward=c.get("per_coarse_forward", 0),
                 per_val_forward=c.get("per_val_forward", 0),
                 **launch_plan(tc.kernel_path(ci, co), dims, ci, co, 2, nb),
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


def phantom_hu(z, y, x, rng, noise=20.0):
    """A CT-like int16 volume sampled at the millimetre coordinates ``z``,
    ``y``, ``x`` (1-D, 0 at the centre): air at -1000 HU, an elliptic body
    (soft tissue inside a fat ring, 60% and 40% of it), organs, a spine,
    gaussian noise of ``noise`` HU."""
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
    if noise:
        img += rng.normal(0, noise, img.shape).astype(np.int16)
    return img


def make_ct(path, seed=0, slices=240):
    """Write the phantom as a 512x512x``slices`` int16 volume at
    0.7x0.7x1.25 mm; returns its voxels (z, y, x)."""
    import numpy as np
    from segmentation3d_tpu_torch.io import Volume, write_image
    from segmentation3d_tpu_torch.ops.geometry import Frame
    sp = np.array([0.7, 0.7, 1.25])  # x, y, z
    z, y, x = ((np.arange(n) - n / 2) * d for n, d in
               ((slices, sp[2]), (512, sp[1]), (512, sp[0])))
    img = phantom_hu(z, y, x, np.random.default_rng(seed))
    write_image(Volume(img, Frame.identity(spacing=sp)), path)
    return img


def seeded_vnet(torch, seed=0, bottleneck=False):
    """Full-width V-Net (base 16, 1 -> 2 classes; ``bottleneck``: VB-Net)
    with seeded weights and non-trivial BatchNorm statistics, from an
    explicit torch.Generator."""
    from segmentation3d_tpu_torch.models.vnet import SegmentationNet
    net = SegmentationNet(in_channels=1, out_channels=2, bottleneck=bottleneck)
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


def coarse_patches(rng):
    """The coarse-to-fine coarse pass's 96^3 grid at 4 mm over
    :func:`make_ct`'s 512x512x240 volume (first voxel at (-179.2, -179.2,
    -150) mm), as ``seg_infer`` pads it to its shape bucket: the phantom
    inside the volume (90 x 90 x 75 voxels), the resampler's fill (0 HU)
    beyond it; two noise draws. Returns ``(hu, fit, fg)`` for
    :func:`calibrate`: every voxel fitted, the body (not the fill) as the
    foreground."""
    import numpy as np
    g = np.arange(96) * 4.0
    hu = np.stack([phantom_hu(g - 150.0, g - 179.2, g - 179.2, rng)
                   for _ in range(2)])
    pad = np.zeros(hu.shape, bool)
    pad[:, 75:] = pad[:, :, 90:] = pad[:, :, :, 90:] = True
    hu[pad] = 0
    return hu, np.ones(hu.shape, bool), (hu > -500) & ~pad


def calibrate(torch, net, normalizer, seed=1, patches=None):
    """Give ``net`` the BatchNorm statistics of two seeded 96^3 phantom
    patches at 1 mm (one inside the body, one across its edge), as training
    would leave them, and fit its head conv to the patches' soft tissue (HU
    above -30: muscle, organs, bone; not fat, lung or air) by one
    least-squares solve over its 3^3 x 32 inputs at 60,000 body voxels, as
    a trained head separates its classes with a margin. A random head
    leaves most voxels at one constant logit, so a mask check on it is
    vacuous; a random head biased to its median log-odds puts the decision
    boundary in the densest part of the body, where the int8 forward's own
    rounding flips a few percent of the voxels. ``patches``: a
    ``(function of the seeded numpy Generator) -> (hu, fit, fg)`` giving
    other patches, the voxels to fit at and the foreground instead
    (:func:`coarse_patches`)."""
    import numpy as np
    import torch.nn.functional as F
    rng = np.random.default_rng(seed)
    if patches is None:
        mm = np.arange(96) + 0.5
        hu = np.stack([phantom_hu(mm - 48, mm - 60, mm + 20, rng),
                       phantom_hu(mm - 48, mm + 40, mm - 48, rng)])
        # fitted on the body only, as air would pull a near-linear fit
        # towards putting fat on the soft-tissue side
        fit, fg = hu > -500, hu > -30
    else:
        hu, fit, fg = patches(rng)
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
    # the head conv's input [N, 32, D, H, W] at sampled voxels, tap by tap
    f = F.pad(feats[0], (1, 1, 1, 1, 1, 1))
    vox = torch.nonzero(torch.from_numpy(fit))
    g = torch.Generator().manual_seed(seed)
    n, z, y, xx = vox[torch.randperm(len(vox), generator=g)[:60000]].T
    a = torch.cat([f[n, :, z + dz, y + dy, xx + dx] for dz in range(3)
                   for dy in range(3) for dx in range(3)], dim=1).double()
    a = torch.cat([a, torch.ones(len(a), 1, dtype=a.dtype)], dim=1)
    target = torch.from_numpy(fg)[n, z, y, xx].double() * 2 - 1
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

    def run(tag, extra, inputs=None):
        """One case through the CLI: ``inputs`` (default: this case, this
        model) + the SIZE partition + ``extra``."""
        out = os.path.join(workdir, tag)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = seg_infer((inputs or ["-i", ct, "-m", model_dir]) + ["-o", out]
                        + part + extra)
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
    return dict(launches=launches, run=run, f32=f32, body=body, ct=ct, shape=shape,
                n_batches=n_batches, model_dir=model_dir, norm=norm,
                bf16_mask=first["mask"], bf16_out=first["out"], serial=second,
                workdir=workdir, part=part)


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
        ctx[tag + "_mask"] = r["mask"]
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


#: formats phase: agreement of the DICOM and NRRD runs' masks with the NIfTI
#: run's (their frames are stored as decimal strings, NIfTI's as float32, so
#: the grids may differ in the last bits), and the slab of the compressed
#: series (their encoders are pure Python)
FORMAT_AGREE_MIN = 0.999
FORMAT_DICE_MIN = 0.999
FRAME_TOL = 1e-6
SLAB = 16


def frame_gap(a, b):
    """Largest absolute difference of two frames' origin, spacing and
    direction."""
    import numpy as np
    return float(max(np.abs(np.asarray(getattr(a, k)) - np.asarray(getattr(b, k))).max()
                     for k in ("origin", "spacing", "direction")))


def phase_formats(torch, tc, ctx, gpu):
    """The main case as a DICOM series of 240 uncompressed files and as a
    gzipped .nrrd: each reads to the NIfTI voxels exactly (frames within
    FRAME_TOL), runs ``seg_infer --bf16`` with 20 x 23 launches and gives
    the NIfTI run's mask on >= FORMAT_AGREE_MIN of voxels; a 512x512 slab
    as an RLE and a JPEG Lossless series reads back exactly, the native
    JPEG scan decode equals the Python loop on one slice; ``seg_eval``
    scores both masks against the NIfTI run's."""
    import csv
    import numpy as np
    from segmentation3d_tpu_torch.cli.seg_eval import main as seg_eval
    from segmentation3d_tpu_torch.io import Volume, dicom, read_image, write_image
    from segmentation3d_tpu_torch.io import jpeg_lossless as jl
    run, n_batches, workdir = ctx["run"], ctx["n_batches"], ctx["workdir"]
    ref = read_image(ctx["ct"])
    inputs = {"dicom": os.path.join(workdir, "ct_dicom"),
              "nrrd": os.path.join(workdir, "ct_nrrd.nrrd")}
    masks = {}
    for fmt, path in inputs.items():
        t = time.perf_counter()
        if fmt == "dicom":
            dicom.write_dicom_series(path, ref.data, ref.frame)
        else:
            write_image(Volume(ref.data, ref.frame), path)
        written = time.perf_counter() - t
        t = time.perf_counter()
        vol = read_image(path)
        read_s = time.perf_counter() - t
        check(vol.data.shape == ref.data.shape and np.array_equal(vol.data, ref.data),
              f"{fmt}: voxels differ from the NIfTI case's")
        gap = frame_gap(vol.frame, ref.frame)
        check(gap <= FRAME_TOL, f"{fmt}: frame {gap} from the NIfTI case's")
        del vol
        # this format's path: counts reset just before, read just after
        tc.thin_conv3d.launches = 0
        r = run(f"bf16_{fmt}", ["--bf16"], inputs=["-i", path, "-m", ctx["model_dir"]])
        launches = tc.thin_conv3d.launches
        differ = int(np.sum(r["mask"] != ctx["bf16_mask"]))
        agree = 1.0 - differ / r["mask"].size
        masks[fmt] = (r, launches)
        emit("formats", input=fmt, launches=launches, patch_batches=n_batches,
             write_seconds=written, read_image_seconds=read_s, frame_gap=gap,
             voxels_differing=differ, agreement=agree, min_agreement=FORMAT_AGREE_MIN,
             seconds=r["wall"], stages=r["stages"], volumes_per_min=60.0 / r["wall"],
             files=len(os.listdir(path)) if fmt == "dicom" else 1, gpu=gpu)
        check(launches == 20 * n_batches,
              f"{fmt}: thin_conv3d launched {launches} times, expected 20 x {n_batches}")
        check(agree >= FORMAT_AGREE_MIN,
              f"{fmt}: mask agrees with the NIfTI run's on {agree} < {FORMAT_AGREE_MIN}")

    slab = ref.data[:SLAB]
    for syntax in ("rle", "jpeg_lossless"):
        folder = os.path.join(workdir, f"slab_{syntax}")
        t = time.perf_counter()
        dicom.write_dicom_series(folder, slab, ref.frame, compress=syntax)
        encode_s = time.perf_counter() - t
        files = sorted(os.path.join(folder, f) for f in os.listdir(folder))
        parsed = [dicom._read_file(p) for p in files]
        t = time.perf_counter()
        for e, p in zip(parsed, files):
            dicom._file_slices(e, p)
        decode_ms = 1e3 * (time.perf_counter() - t) / len(files)
        back = read_image(folder).data
        check(np.array_equal(back, slab), f"{syntax}: slab does not read back exactly")
        extra = {}
        if syntax == "jpeg_lossless":
            blob = b"".join(parsed[0][dicom.TAG_PIXEL_DATA])
            info = jl._parse(blob)
            f = info["frame"]
            luts = jl._build_lut(*info["huff"][(0, info["scomps"][0]["td"])])
            args = (blob[info["scan_at"]:], *luts, f["width"], f["height"],
                    f["precision"], info["predictor"], info["pt"], info["ri"])
            t = time.perf_counter()
            native_scan = jl._decode_scan_native(*args)
            extra["native_scan_ms"] = 1e3 * (time.perf_counter() - t)
            t = time.perf_counter()
            python_scan = jl._decode_scan_py(*args)
            extra["python_scan_ms"] = 1e3 * (time.perf_counter() - t)
            check(np.array_equal(native_scan, python_scan),
                  "the native JPEG scan decode differs from the Python loop")
        emit("formats_slab", syntax=syntax, slices=len(files), shape=list(slab.shape),
             encode_seconds=encode_s, decode_ms_per_slice=decode_ms,
             bytes=sum(os.path.getsize(p) for p in files), **extra, gpu=gpu)

    pairs = os.path.join(workdir, "eval_pairs.csv")
    nifti_mask = os.path.join(ctx["bf16_out"], "seg.mha")
    with open(pairs, "w") as f:
        f.write("pred,gt\n" + "".join(
            f"{os.path.join(r['out'], 'seg.mha')},{nifti_mask}\n"
            for r, _ in masks.values()))
    scores = os.path.join(workdir, "eval.csv")
    t = time.perf_counter()
    seg_eval(["-i", pairs, "-o", scores])
    eval_s = time.perf_counter() - t
    with open(scores, newline="") as f:
        rows = [r for r in csv.DictReader(f) if r["class"] == "1"]
    dice = {fmt: float(r["dice"]) for fmt, r in zip(masks, rows)}
    emit("formats_eval", foreground_dice=dice, min_dice=FORMAT_DICE_MIN,
         seconds=eval_s, gpu=gpu)
    check(len(rows) == len(masks), f"seg_eval scored {len(rows)} of {len(masks)} masks")
    for fmt, d in dice.items():
        check(d >= FORMAT_DICE_MIN, f"{fmt}: foreground Dice {d} < {FORMAT_DICE_MIN}")
    return {f"seg_infer --bf16 ({fmt})": n for fmt, (_, n) in masks.items()}


def check_gaps(tag, gaps, dice_min, dprob_max):
    """Fail unless ``gaps`` (:func:`mask_gaps`, the float32 run first) are
    within the limits and the float32 foreground holds its share of the
    body."""
    fg_body = gaps["foreground_fraction_of_body"]
    check(FG_BODY[0] <= fg_body <= FG_BODY[1],
          f"{tag}: foreground is {fg_body} of the body, outside {FG_BODY}")
    check(gaps["agreement"] >= AGREE_MIN,
          f"{tag} agreement {gaps['agreement']} < {AGREE_MIN}")
    check(gaps["foreground_dice"] >= dice_min,
          f"{tag} foreground Dice {gaps['foreground_dice']} < {dice_min}")
    check(gaps["max_abs_dprob"] <= dprob_max,
          f"{tag} max |dprob| {gaps['max_abs_dprob']} > {dprob_max}")


#: patch batches of each case of the pipeline phase: 96^3 boxes at stride 64
#: in batches of 8 over a 384x384x320 iso grid (6 x 6 x 5 boxes) for the
#: 240-slice cases and a 384x384x256 one (6 x 6 x 4) for the 160-slice case
PIPE_BATCHES = {"a_main": 23, "b_seed1": 23, "c_short": 18}


def phase_pipeline(torch, tc, ctx, gpu):
    """``seg_infer --bf16`` over a folder of three cases (the main case, a
    second seed, a 512x512x160 case): the pipelined loop overlaps one case's
    read and write with another's device work. The main case's mask must
    equal the main path's; the others' foreground must hold its share of
    their bodies."""
    import shutil
    import numpy as np
    from segmentation3d_tpu_torch.cli.seg_infer import main as seg_infer
    from segmentation3d_tpu_torch.core.seg_infer import default_decoders
    from segmentation3d_tpu_torch.io import read_image
    folder = os.path.join(ctx["workdir"], "pipeline_in")
    os.makedirs(folder)
    t = time.perf_counter()
    shutil.copy(ctx["ct"], os.path.join(folder, "a_main.nii.gz"))
    bodies = {"a_main": ctx["body"],
              "b_seed1": make_ct(os.path.join(folder, "b_seed1.nii.gz"), seed=1) > -500,
              "c_short": make_ct(os.path.join(folder, "c_short.nii.gz"), seed=2,
                                 slices=160) > -500}
    setup = time.perf_counter() - t
    out = os.path.join(ctx["workdir"], "pipeline")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the pipelined path: counts reset just before, read just after
    tc.thin_conv3d.launches = 0
    t0 = time.perf_counter()
    res = seg_infer(["-i", folder, "-m", ctx["model_dir"], "-o", out]
                    + ctx["part"] + ["--bf16"])
    wall = time.perf_counter() - t0
    launches, peak = tc.thin_conv3d.launches, torch.cuda.max_memory_allocated()
    check([r[0] for r in res] == list(PIPE_BATCHES), f"pipeline results {res}")
    check(launches == 20 * sum(PIPE_BATCHES.values()),
          f"thin_conv3d launched {launches} times in the pipeline, expected "
          f"20 x {sum(PIPE_BATCHES.values())}")
    fg, differ = {}, None
    for name, body in bodies.items():
        mask = read_image(os.path.join(out, name, "seg.mha")).data
        check(mask.shape == body.shape, f"{name}: mask shape {mask.shape}")
        fg[name] = float(np.mean((mask == 1)[body]))
        if name == "a_main":
            differ = int(np.sum(mask != ctx["bf16_mask"]))
    serial = ctx["serial"]
    emit("pipeline", cases=[dict(name=n, seconds=sec, stages=st) for n, sec, st in res],
         launches=launches, patch_batches=PIPE_BATCHES, wall_seconds=wall,
         volumes_per_min=60.0 * len(res) / wall,
         serial_seconds=serial["wall"], serial_volumes_per_min=60.0 / serial["wall"],
         serial_stages=serial["stages"], main_case_voxels_differing=differ,
         foreground_fraction_of_body=fg, max_memory_allocated=peak,
         serial_max_memory_allocated=serial["peak"], cpu_count=os.cpu_count(),
         decode_threads=default_decoders(), setup_seconds=setup, gpu=gpu)
    check(differ == 0, f"the pipelined main case differs from the main path's "
          f"bf16 mask in {differ} voxels")
    ctx["pipeline"] = dict(folder=folder, out=out, volumes_per_min=60.0 * len(res) / wall,
                           wall=wall)
    for name in ("b_seed1", "c_short"):
        check(FG_BODY[0] <= fg[name] <= FG_BODY[1],
              f"{name}: foreground is {fg[name]} of the body, outside {FG_BODY}")

#: shard phase: agreement of a patch-sharded run's mask with the unsharded
#: run's (sharding reassociates float32 sums, so an argmax near-tie may
#: flip), the largest probability gap between the engines' outputs
#: (tests/test_spatial_shard.py's bar), and the z-sharded runs' agreement
#: with the unsharded SLAB engine (its 3-D weight map floors at 1e-3 of its
#: peak; the z-only profile does not: tests/test_spatial_shard.py:137)
SHARD_AGREE_MIN = 0.99999
SHARD_DPROB_MAX = 1e-5
SLAB_AGREE_MIN = 0.999
SLAB_PZ, SLAB_SZ, SLAB_COUNT = 64, 48, 7  # 7 slabs of 64 x 384 x 384 over z = 320

RANK_SCRIPT = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from segmentation3d_tpu_torch.cli.seg_infer import main
from segmentation3d_tpu_torch.ops import thin_conv as tc
tc.thin_conv3d.launches = 0
res = main(sys.argv[2:])
print(json.dumps({"cases": [r[0] for r in res], "launches": tc.thin_conv3d.launches}))
"""


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_shard(torch, tc, wi, ctx, gpu):
    """Several shards on the one card, through the entry points a user
    calls, each held against its unsharded run; two ``seg_infer`` processes
    in a gloo group. Returns the launches by path: ``(thin_conv3d,
    window_conv_i8)``."""
    import numpy as np
    from segmentation3d_tpu_torch.cli.seg_infer import main as seg_infer
    from segmentation3d_tpu_torch.core.infer_engine import SlidingWindowInferer
    from segmentation3d_tpu_torch.core.seg_infer import (
        build_forward, load_seg_model, prep_channels, segmentation)
    from segmentation3d_tpu_torch.core.spatial_shard import SpatialShardedInferer
    from segmentation3d_tpu_torch.io import read_image
    from segmentation3d_tpu_torch.ops.geometry import resampled_frame
    dev = torch.device("cuda", 0)
    ct, model_dir, workdir, nb = ctx["ct"], ctx["model_dir"], ctx["workdir"], ctx["n_batches"]
    size = dict(partition_type="SIZE", partition_size=[PATCH] * 3,
                partition_stride=[64] * 3)
    slab = dict(partition_type="SLAB", partition_size=[SLAB_PZ] * 3,
                partition_stride=[SLAB_SZ] * 3)

    def entry(tag, **kw):
        """One case through segmentation() with the launches it made."""
        out = os.path.join(workdir, tag)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tc.thin_conv3d.launches = wi.window_conv_i8.launches = 0
        t0 = time.perf_counter()
        res = segmentation(ct, model_dir, out, dtype=torch.bfloat16, **kw)
        wall = time.perf_counter() - t0
        launches = (tc.thin_conv3d.launches, wi.window_conv_i8.launches)
        mask = read_image(os.path.join(out, res[0][0], "seg.mha")).data
        check(mask.shape == ctx["shape"], f"{tag}: mask shape {mask.shape}")
        return dict(mask=mask, seconds=wall, stages=res[0][2], launches=launches,
                    peak=torch.cuda.max_memory_allocated())

    def agreement(a, b):
        return float(np.mean(a == b))

    # the engines' inputs: the main case on its padded 1 mm grid, as
    # segmentation_one_case prepares it, and the forwards the entry builds
    model = load_seg_model(model_dir, dev)
    vol = read_image(ct)
    _, valid = resampled_frame(vol.frame, vol.size_xyz, model.spacing, 1)
    frame, grid = resampled_frame(vol.frame, vol.size_xyz, model.spacing, 64)
    iso = prep_channels(model, [vol], None, frame, grid, valid, 0.0, dev)
    del vol
    fwd = {"bf16": build_forward(model.net, torch.bfloat16, dev),
           "int8": build_forward(model.net, torch.bfloat16, dev, quant="int8")}

    def engine_gap(f, n):
        """Largest probability gap and voxels differing between the SIZE
        engine on ``n`` shards and unsharded, at the iso grid."""
        kw = dict(batch_size=BATCH, blend="gaussian")
        m1, p1 = SlidingWindowInferer(f, (PATCH,) * 3, 2, **kw)(
            iso, stride_zyx=(64,) * 3, return_prob=True)
        mn, pn = SlidingWindowInferer({dev: f}, (PATCH,) * 3, 2, devices=[dev] * n, **kw)(
            iso, stride_zyx=(64,) * 3, return_prob=True)
        return (pn - p1).abs().max().item(), int((mn != m1).sum().item())

    # (a), (b): patch sharding over 2 shards of the card, bf16 and int8
    patch = {}
    for tag, quant, ref, expect in (("bf16", None, ctx["bf16_mask"], (20 * nb, 0)),
                                    ("int8", "int8", ctx["int8_prob_mask"],
                                     (nb, 19 * nb))):
        r = entry(f"shard_{tag}", device=[dev] * 2, quant=quant, **size)
        gap, differ = engine_gap(fwd[tag], 2)
        patch[tag] = dict(seconds=r["seconds"], stages=r["stages"],
                          max_memory_allocated=r["peak"], launches=r["launches"],
                          agreement_with_unsharded=agreement(r["mask"], ref),
                          engine_max_abs_dprob=gap, engine_voxels_differing=differ)
        check(r["launches"] == expect,
              f"2 patch shards ({tag}) launched (thin_conv3d, window_conv_i8) "
              f"{r['launches']}, expected {expect}")
        check(patch[tag]["agreement_with_unsharded"] >= SHARD_AGREE_MIN,
              f"2 patch shards ({tag}) agree with the unsharded mask on "
              f"{patch[tag]['agreement_with_unsharded']} < {SHARD_AGREE_MIN}")
        check(gap <= SHARD_DPROB_MAX,
              f"2 patch shards ({tag}): max |dprob| {gap} > {SHARD_DPROB_MAX}")

    # (c): spatial sharding of SLAB 64/48 over 1, 2 and 8 shards
    D = int(iso.shape[0])
    check(D == 320, f"the iso grid has {D} planes, not 320")
    slab_m = SlidingWindowInferer(fwd["bf16"], (SLAB_PZ,) + tuple(iso.shape[1:3]), 2,
                                  batch_size=1, blend="gaussian")(
        iso, stride_zyx=(SLAB_SZ,) + tuple(iso.shape[1:3]))
    spatial, ref = {}, None
    for n in (1, 2, 8):
        inf = SpatialShardedInferer({dev: fwd["bf16"]}, SLAB_PZ, 2, [dev] * n,
                                    stride_z=SLAB_SZ)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tc.thin_conv3d.launches = 0
        t0 = time.perf_counter()
        m, p = inf(iso, return_prob=True)
        torch.cuda.synchronize()
        seconds, launches = time.perf_counter() - t0, tc.thin_conv3d.launches
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()  # again, with the allocator's blocks cached
        inf(iso)
        torch.cuda.synchronize()
        # the peak of the 2- and 8-shard runs holds the 1-shard run's prob
        # and mask for the comparison (0.42 GB)
        row = dict(seconds=seconds, seconds_again=time.perf_counter() - t0,
                   launches=launches, max_memory_allocated=peak,
                   planes_per_shard=-(-max(D, SLAB_PZ) // n),
                   agreement_with_slab=float((m == slab_m).float().mean().item()))
        if ref is None:
            ref = (m, p)
        else:
            row.update(max_abs_dprob_vs_1=(p - ref[1]).abs().max().item(),
                       voxels_differing_vs_1=int((m != ref[0]).sum().item()))
        spatial[n] = row
        check(row["launches"] == 20 * SLAB_COUNT,
              f"{n} z-shards launched thin_conv3d {row['launches']} times, "
              f"expected 20 x {SLAB_COUNT}")
        check(row["agreement_with_slab"] >= SLAB_AGREE_MIN,
              f"{n} z-shards agree with the SLAB engine on "
              f"{row['agreement_with_slab']} < {SLAB_AGREE_MIN}")
        if n > 1:
            check(row["voxels_differing_vs_1"] == 0,
                  f"{n} z-shards' mask differs from 1 shard's in "
                  f"{row['voxels_differing_vs_1']} voxels")
            check(row["max_abs_dprob_vs_1"] <= SHARD_DPROB_MAX,
                  f"{n} z-shards: max |dprob| {row['max_abs_dprob_vs_1']} vs 1 shard")
        del m, p
    del ref, slab_m, iso, fwd
    # the entry point: 8 z-shards against the unsharded SLAB path
    sp8 = entry("shard_spatial8", device=[dev] * 8, spatial_shard=True, **slab)
    slab1 = entry("shard_slab", device=dev, **slab)
    spatial_entry = dict(seconds=sp8["seconds"], stages=sp8["stages"],
                         max_memory_allocated=sp8["peak"], launches=sp8["launches"][0],
                         slab_seconds=slab1["seconds"],
                         slab_max_memory_allocated=slab1["peak"],
                         agreement_with_slab=agreement(sp8["mask"], slab1["mask"]))
    check(sp8["launches"] == (20 * SLAB_COUNT, 0),
          f"segmentation(spatial_shard, 8 shards) launched {sp8['launches']}")
    check(spatial_entry["agreement_with_slab"] >= SLAB_AGREE_MIN,
          f"segmentation(spatial_shard, 8 shards) agrees with the SLAB path on "
          f"{spatial_entry['agreement_with_slab']} < {SLAB_AGREE_MIN}")

    # (d): the CLI on the card
    out = os.path.join(workdir, "shard_cli_all")
    tc.thin_conv3d.launches = 0
    res = seg_infer(["-i", ct, "-m", model_dir, "-o", out, "--bf16",
                     "--num_devices", "-1"] + ctx["part"])
    cli_launches = tc.thin_conv3d.launches
    cli_mask = read_image(os.path.join(out, res[0][0], "seg.mha")).data
    cli_differ = int(np.sum(cli_mask != ctx["bf16_mask"]))
    count = torch.cuda.device_count()
    check(cli_launches == 20 * nb, f"--num_devices -1 launched {cli_launches}")
    check(cli_differ == 0 if count == 1 else
          agreement(cli_mask, ctx["bf16_mask"]) >= SHARD_AGREE_MIN,
          f"--num_devices -1 on {count} card(s) differs from the main path's "
          f"mask in {cli_differ} voxels")
    refusal = None
    if count == 1:
        try:
            seg_infer(["-i", ct, "-m", model_dir, "-o", out, "--bf16", "--spatial_shard",
                       "--num_devices", "2", "--partition_type", "SLAB"])
        except ValueError as e:
            refusal = str(e)
        check(refusal == "spatial_shard requires num_devices > 1",
              f"--spatial_shard --num_devices 2 on one card: {refusal!r}")

    # (e): two processes on the one card, over the pipeline phase's folder
    pipe = ctx["pipeline"]
    out = os.path.join(workdir, "shard_two_procs")
    argv = ["-i", pipe["folder"], "-m", model_dir, "-o", out, "--bf16"] + ctx["part"]
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, HERE] + argv,
                              env=dict(env, RANK=str(rank)), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for rank in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    pair_wall = time.perf_counter() - t0
    for rank, (p, (so, se)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"seg_infer rank {rank} exited {p.returncode}: "
              f"{se.strip()[-2000:]}")
    ranks = [json.loads(so.strip().splitlines()[-1]) for so, _ in outs]
    check([r["cases"] for r in ranks] == [["a_main", "c_short"], ["b_seed1"]],
          f"the two processes ran {[r['cases'] for r in ranks]}")
    check([r["launches"] for r in ranks] == [
        20 * (PIPE_BATCHES["a_main"] + PIPE_BATCHES["c_short"]),
        20 * PIPE_BATCHES["b_seed1"]], f"rank launches {ranks}")
    differ = {}
    for name in PIPE_BATCHES:
        a = read_image(os.path.join(out, name, "seg.mha")).data
        b = read_image(os.path.join(pipe["out"], name, "seg.mha")).data
        differ[name] = int(np.sum(a != b))
    check(not any(differ.values()), f"two processes' masks differ from the "
          f"pipeline's: {differ}")
    emit("shard", patch=patch, spatial_engine=spatial, spatial_entry=spatial_entry,
         cli_num_devices_all=dict(devices=count, launches=cli_launches,
                                  voxels_differing_from_main_path=cli_differ,
                                  spatial_refusal=refusal),
         two_processes=dict(wall_seconds=pair_wall,
                            volumes_per_min=60.0 * len(PIPE_BATCHES) / pair_wall,
                            pipeline_wall_seconds=pipe["wall"],
                            pipeline_volumes_per_min=pipe["volumes_per_min"],
                            ranks=ranks, voxels_differing=differ),
         gpu=gpu)
    thin = {"segmentation, 2 patch shards (bf16)": patch["bf16"]["launches"][0],
            "segmentation, 2 patch shards (int8 stems)": patch["int8"]["launches"][0],
            "segmentation, 8 z-shards (SLAB 64/48)": sp8["launches"][0],
            "seg_infer --num_devices -1": cli_launches,
            "seg_infer, 2 processes (rank 0 + rank 1)": sum(r["launches"] for r in ranks)}
    return thin, {"segmentation, 2 patch shards (int8)": patch["int8"]["launches"][1]}


def save_model(torch, ctx, tag, net, net_name="vnet", spacing=1.0):
    from segmentation3d_tpu_torch.utils.model_io import save_checkpoint
    path = os.path.join(ctx["workdir"], tag)
    save_checkpoint(path, 1, 0, net.state_dict(), net_name, 16, 1, 2,
                    [spacing] * 3, "LINEAR", [ctx["norm"]])
    return path


def phase_ensemble(torch, tc, ctx, gpu):
    """``-m a -m b --bf16`` (a second seeded model) against the float32
    ensemble under the bf16 limits, with both members' kernel launches;
    ``-m a -m a`` must give exactly the main path's bf16 mask."""
    import numpy as np
    from segmentation3d_tpu_torch.io import read_image
    run, ct, a = ctx["run"], ctx["ct"], ctx["model_dir"]
    b = save_model(torch, ctx, "model_b",
                   calibrate(torch, seeded_vnet(torch, seed=1), ctx["norm"], seed=2))
    tc.thin_conv3d.launches = 0
    bf16 = run("ens_bf16", ["--bf16", "--save_prob"], ["-i", ct, "-m", a, "-m", b])
    launches = tc.thin_conv3d.launches
    f32 = run("ens_f32", ["--save_prob"], ["-i", ct, "-m", a, "-m", b])
    same = run("ens_aa", ["--bf16"], ["-i", ct, "-m", a, "-m", a])
    gaps = mask_gaps(np, read_image, f32, bf16, ctx["body"])
    differ = int(np.sum(same["mask"] != ctx["bf16_mask"]))
    emit("ensemble", launches=launches, **gaps,
         agreement_with_member_a=float(np.mean(bf16["mask"] == ctx["bf16_mask"])),
         aa_voxels_differing_from_main_path=differ, seconds=bf16["wall"],
         stages=bf16["stages"], f32_seconds=f32["wall"],
         max_memory_allocated=bf16["peak"], gpu=gpu)
    check(launches == 2 * 20 * ctx["n_batches"],
          f"ensemble launched thin_conv3d {launches} times, expected "
          f"2 x 20 x {ctx['n_batches']}")
    check_gaps("ensemble bf16/f32", gaps, DICE_MIN, DPROB_MAX)
    check(differ == 0, f"-m a -m a differs from -m a in {differ} voxels")


def phase_tta(torch, tc, ctx, gpu):
    """``--bf16 --tta all`` (8 flips of every batch) against float32
    ``--tta all`` under the bf16 limits."""
    import numpy as np
    from segmentation3d_tpu_torch.io import read_image
    run = ctx["run"]
    tc.thin_conv3d.launches = 0
    bf16 = run("tta_bf16", ["--bf16", "--tta", "all", "--save_prob"])
    launches = tc.thin_conv3d.launches
    f32 = run("tta_f32", ["--tta", "all", "--save_prob"])
    gaps = mask_gaps(np, read_image, f32, bf16, ctx["body"])
    emit("tta", launches=launches, **gaps,
         agreement_with_no_tta=float(np.mean(bf16["mask"] == ctx["bf16_mask"])),
         seconds=bf16["wall"], stages=bf16["stages"], f32_seconds=f32["wall"],
         f32_stages=f32["stages"], max_memory_allocated=bf16["peak"], gpu=gpu)
    check(launches == 8 * 20 * ctx["n_batches"],
          f"--tta all launched thin_conv3d {launches} times, expected "
          f"8 x 20 x {ctx['n_batches']}")
    check_gaps("tta bf16/f32", gaps, DICE_MIN, DPROB_MAX)


def phase_c2f(torch, tc, wi, ctx, gpu):
    """Coarse-to-fine: a seeded 4 mm coarse net fitted to the phantom's body
    on its padded coarse grid (:func:`coarse_patches`) finds the ROI in one
    batch-1 forward of that grid, and the main model runs inside it. ``--bf16`` and ``--int8`` against the float32 run, with
    each kernel's launches: the coarse forward's 20, plus 20 (bf16) or
    1 + 19 (int8) per fine batch."""
    import numpy as np
    from segmentation3d_tpu_torch.io import read_image
    run = ctx["run"]
    coarse = save_model(torch, ctx, "coarse", calibrate(
        torch, seeded_vnet(torch, seed=2), ctx["norm"], seed=3,
        patches=coarse_patches), spacing=4.0)
    inputs = ["-i", ctx["ct"], "-m", coarse, "--fine_model", ctx["model_dir"]]
    f32 = run("c2f_f32", ["--save_prob"], inputs)
    tc.thin_conv3d.launches = 0
    bf16 = run("c2f_bf16", ["--bf16", "--save_prob"], inputs)
    thin = tc.thin_conv3d.launches
    tc.thin_conv3d.launches = 0
    wi.window_conv_i8.launches = 0
    int8 = run("c2f_int8", ["--int8", "--save_prob"], inputs)
    thin8, win8 = tc.thin_conv3d.launches, wi.window_conv_i8.launches
    fine_batches = (thin - 20) // 20
    gaps = {tag: mask_gaps(np, read_image, f32, r, ctx["body"])
            for tag, r in (("bf16", bf16), ("int8", int8))}
    emit("c2f", launches=dict(bf16=thin, int8=dict(thin_conv3d=thin8,
                                                   window_conv_i8=win8)),
         fine_batches=fine_batches, main_path_batches=ctx["n_batches"],
         gaps=gaps, seconds=dict(f32=f32["wall"], bf16=bf16["wall"],
                                 int8=int8["wall"]),
         stages=dict(bf16=bf16["stages"], int8=int8["stages"]),
         max_memory_allocated=bf16["peak"], gpu=gpu)
    # the ROI was found: the fine pass ran. This seeded coarse net labels a
    # few scattered voxels of air and padding far from the body foreground,
    # so its ROI spans the volume and the fine grid has the flat grid's size
    # (centre-anchored on the ROI, so sampled at other points)
    check(thin == 20 + 20 * fine_batches and fine_batches >= 1,
          f"c2f --bf16 launched thin_conv3d {thin} times: not 20 + 20 x "
          "fine batches")
    check((thin8, win8) == (20 + fine_batches, 19 * fine_batches),
          f"c2f --int8 launched (thin_conv3d, window_conv_i8) {(thin8, win8)}, "
          f"expected ({20 + fine_batches}, {19 * fine_batches})")
    check_gaps("c2f bf16/f32", gaps["bf16"], DICE_MIN, DPROB_MAX)
    check_gaps("c2f int8/f32", gaps["int8"], *INT8_LIMITS["int8_prob"])
    ctx.update(coarse=coarse, c2f_bf16_mask=bf16["mask"], c2f_launches=thin)


#: thin_conv3d launches per batch of the folded full-width VB-Net: the stem,
#: the head and the 14 mid convs of 8, 32 and 64 channels (16: cuDNN)
VBNET_PER_BATCH = 16


def phase_vbnet(torch, tc, wi, ctx, gpu):
    """A seeded full-width VB-Net: ``--bf16`` runs its BN-folded forward
    (``VBNET_PER_BATCH`` thin_conv3d launches a batch, no window_conv_i8),
    against float32 at the mask agreement bar. Returns its launch count."""
    import numpy as np
    from segmentation3d_tpu_torch.io import read_image
    run = ctx["run"]
    vb = save_model(torch, ctx, "vbnet", calibrate(
        torch, seeded_vnet(torch, seed=3, bottleneck=True), ctx["norm"], seed=4),
        net_name="vbnet")
    tc.thin_conv3d.launches = 0
    wi.window_conv_i8.launches = 0
    bf16 = run("vbnet_bf16", ["--bf16", "--save_prob"], ["-i", ctx["ct"], "-m", vb])
    launches = (tc.thin_conv3d.launches, wi.window_conv_i8.launches)
    f32 = run("vbnet_f32", ["--save_prob"], ["-i", ctx["ct"], "-m", vb])
    gaps = mask_gaps(np, read_image, f32, bf16, ctx["body"])
    emit("vbnet", launches=launches, **gaps, seconds=bf16["wall"],
         stages=bf16["stages"], f32_seconds=f32["wall"],
         max_memory_allocated=bf16["peak"], gpu=gpu)
    check(launches == (VBNET_PER_BATCH * ctx["n_batches"], 0),
          f"vbnet --bf16 launched {launches}: expected "
          f"({VBNET_PER_BATCH} x {ctx['n_batches']}, 0)")
    fg_body = gaps["foreground_fraction_of_body"]
    check(FG_BODY[0] <= fg_body <= FG_BODY[1],
          f"vbnet: foreground is {fg_body} of the body, outside {FG_BODY}")
    check(gaps["agreement"] >= AGREE_MIN,
          f"vbnet bf16/f32 agreement {gaps['agreement']} < {AGREE_MIN}")
    # the earlier phases' sessions hold their CUDA graphs' pools and the
    # float32 runs leave GBs cached that a later capture's pool cannot
    # reuse: the next phases start from an empty cache
    import gc
    from segmentation3d_tpu_torch.core import seg_infer as si
    si._SESSIONS.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return {"seg_infer --bf16 (vbnet)": launches[0]}


def phase_convert(torch, tc, ctx, gpu):
    """The main path's model as the original PyTorch toolkit saves it (the
    same tensors in torch's order under its own names, the self-describing
    keys, no ``_kernel_layouts``): ``seg_infer --bf16`` loads it through the
    positional importer, and the model ``seg_convert`` writes from it, must
    each give the main path's mask voxel for voxel with 20 launches per
    batch."""
    from segmentation3d_tpu_torch.cli.seg_convert import main as seg_convert
    from segmentation3d_tpu_torch.compat.torch_import import import_torch_state_dict
    from segmentation3d_tpu_torch.models import create_network
    from segmentation3d_tpu_torch.utils import model_io
    native = model_io.load_checkpoint_payload(model_io.latest_checkpoint(ctx["model_dir"]))
    toolkit = os.path.join(ctx["workdir"], "toolkit_model")
    chk = os.path.join(toolkit, "checkpoints", "chk_1")
    os.makedirs(chk)
    payload = {k: v for k, v in native.items() if k != "_kernel_layouts"}
    # DataParallel-style names that keep only each tensor's last name part
    payload["state_dict"] = {f"module.layers.{i}.{k.rsplit('.', 1)[1]}": t
                             for i, (k, t) in enumerate(native["state_dict"].items())}
    torch.save(payload, os.path.join(chk, "params.pth"))
    net = create_network(native["net"], native["in_channels"], native["out_channels"],
                         **(native.get("net_kwargs") or {}))
    t = time.perf_counter()
    state = import_torch_state_dict(payload["state_dict"], net)
    import_s = time.perf_counter() - t
    check(all(torch.equal(state[k], v) for k, v in native["state_dict"].items()
              if not k.endswith("num_batches_tracked")),
          "the positional import differs from the native state_dict")
    t = time.perf_counter()
    converted = os.path.join(ctx["workdir"], "converted_model")
    seg_convert(["-i", toolkit, "-o", converted])
    convert_s = time.perf_counter() - t
    check("_kernel_layouts" in model_io.load_checkpoint_payload(
        model_io.latest_checkpoint(converted)), "seg_convert wrote no _kernel_layouts")
    runs, launches = {}, {}
    for tag, model in (("toolkit", toolkit), ("converted", converted)):
        # each path: counts reset just before, read just after
        tc.thin_conv3d.launches = 0
        runs[tag] = ctx["run"](f"{tag}_bf16", ["--bf16"], ["-i", ctx["ct"], "-m", model])
        launches[tag] = tc.thin_conv3d.launches
    differ = {tag: int((r["mask"] != ctx["bf16_mask"]).sum()) for tag, r in runs.items()}
    emit("convert", import_seconds=import_s, convert_seconds=convert_s,
         launches=launches, patch_batches=ctx["n_batches"],
         voxels_differing_from_main_path=differ,
         seconds={tag: r["wall"] for tag, r in runs.items()},
         stages={tag: r["stages"] for tag, r in runs.items()}, gpu=gpu)
    for tag in runs:
        check(launches[tag] == 20 * ctx["n_batches"],
              f"{tag} checkpoint: thin_conv3d launched {launches[tag]} times, "
              f"expected 20 x {ctx['n_batches']}")
        check(differ[tag] == 0, f"{tag} checkpoint: the mask differs from the "
              f"main path's in {differ[tag]} voxels")
    return {"seg_infer --bf16 (toolkit checkpoint)": launches["toolkit"],
            "seg_infer --bf16 (seg_convert output)": launches["converted"]}


def socket_path(workdir, tag):
    """A Unix socket in ``workdir``, named relative to the working directory
    where that is shorter (AF_UNIX takes at most 107 bytes)."""
    path = os.path.join(workdir, f"{tag}.sock")
    return min(path, os.path.relpath(path), key=len)


def phase_serve(torch, tc, wi, ctx, gpu):
    """``seg_serve``'s ``main`` in a thread, on a Unix socket, as a
    deployment runs it, with the session caches emptied first as in a new
    server process. A bf16 server: a ping, a burst of three requests from
    three client threads (the pipeline phase's cases, masks equal to that
    phase's), a ping while the first runs, then one more warm request; an
    int8 server calibrated on the main case: two requests; a coarse-to-fine
    server: one request. Load, build and calibration are counted (once per
    server), and so are the prepared requests waiting (at most one)."""
    import threading
    import numpy as np
    from segmentation3d_tpu_torch.cli import seg_serve
    from segmentation3d_tpu_torch.core import coarse_to_fine as c2f
    from segmentation3d_tpu_torch.core import seg_infer as si
    from segmentation3d_tpu_torch.core.serve import request
    from segmentation3d_tpu_torch.io import read_image
    lock = threading.Lock()
    n = dict(load=0, build=0, calib=0, waiting=0, max_waiting=0)
    started = threading.Event()
    patched = []

    def wrap(mod, name, before):
        fn = getattr(mod, name)

        def counted(*a, **kw):
            with lock:
                before()
            return fn(*a, **kw)
        patched.append((mod, name, fn))
        setattr(mod, name, counted)

    def bump(key, by=1):
        def f():
            n[key] += by
            n["max_waiting"] = max(n["max_waiting"], n["waiting"])
        return f

    def run_starts():
        n["waiting"] -= 1
        started.set()
    for mod in (si, c2f):
        wrap(mod, "load_seg_model", bump("load"))
        wrap(mod, "build_forward", bump("build"))
    wrap(si, "_calibrate_for_model", bump("calib"))
    wrap(seg_serve, "prepare_cases", bump("waiting"))
    wrap(seg_serve, "segmentation", run_starts)
    wrap(seg_serve, "segmentation_coarse_to_fine", run_starts)

    def start(tag, argv):
        si._SESSIONS.clear()
        c2f._C2F_SESSIONS.clear()
        torch.cuda.empty_cache()
        for k in n:
            n[k] = 0
        tc.thin_conv3d.launches = wi.window_conv_i8.launches = 0
        sock = socket_path(ctx["workdir"], tag)
        th = threading.Thread(target=seg_serve.main, daemon=True,
                              args=(argv + ctx["part"] + ["--socket", sock],))
        th.start()
        while not os.path.exists(sock):
            check(th.is_alive(), f"{tag}: the server ended before it listened")
            th.join(0.05)
        return sock, th

    def stop(sock, th):
        check(request(sock, {"cmd": "shutdown"}, timeout=60).get("shutdown"),
              "shutdown refused")
        th.join(60)
        check(not th.is_alive(), "the server did not end")

    def mask_of(resp, out):
        check(resp is not None and resp["ok"], f"request failed: {resp}")
        name = resp["results"][0][0]
        return name, read_image(os.path.join(out, name, "seg.mha")).data

    def timed(sock, out, inp, into, i):
        t = time.perf_counter()
        r = request(sock, {"input": inp, "output_dir": out}, timeout=600)
        into[i] = (r, t, time.perf_counter())

    try:
        # ---- bf16: ping, a three-request burst with a ping inside, warm
        model = ctx["model_dir"]
        sock, th = start("serve_bf16", ["-m", model, "--bf16"])
        check(request(sock, {"cmd": "ping"}, timeout=60).get("pong"), "no pong")
        pipe = ctx["pipeline"]
        names = list(PIPE_BATCHES)
        out = os.path.join(ctx["workdir"], "serve_bf16")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        got = [None] * len(names)
        clients = []
        t0 = time.perf_counter()
        for i, name in enumerate(names):
            clients.append(threading.Thread(target=timed, args=(
                sock, out, os.path.join(pipe["folder"], name + ".nii.gz"), got, i)))
            clients[-1].start()
            if i == 0:
                check(started.wait(120), "the first request never started")
                tp = time.perf_counter()
                check(request(sock, {"cmd": "ping"}, timeout=60).get("pong"), "no pong")
                ping_at = time.perf_counter()
            else:
                time.sleep(0.05)  # arrival, hence FIFO, order
        for c in clients:
            c.join(600)
        wall = max(g[2] for g in got) - t0
        burst = dict(launches=tc.thin_conv3d.launches, **n)
        peak = torch.cuda.max_memory_allocated()
        differ = {}
        for name, (r, _, _) in zip(names, got):
            case, mask = mask_of(r, out)
            check(case == name, f"burst answered {case} for {name}")
            ref = read_image(os.path.join(pipe["out"], name, "seg.mha")).data
            differ[name] = int((mask != ref).sum())
        tc.thin_conv3d.launches = 0
        warm = [None]
        timed(sock, os.path.join(ctx["workdir"], "serve_warm"), ctx["ct"], warm, 0)
        warm_launches = tc.thin_conv3d.launches
        _, warm_mask = mask_of(warm[0][0], os.path.join(ctx["workdir"], "serve_warm"))
        stop(sock, th)
        emit("serve", server="bf16", cases=names,
             request_seconds=[g[2] - g[1] for g in got],
             server_seconds=[g[0]["secs"] for g in got],
             ping_seconds=ping_at - tp, ping_before_first_response=ping_at < got[0][2],
             burst_seconds=wall, burst_volumes_per_min=60.0 * len(names) / wall,
             pipeline_volumes_per_min=pipe["volumes_per_min"],
             warm_request_seconds=warm[0][2] - warm[0][1],
             single_call_seconds=ctx["serial"]["wall"], counts=burst,
             warm_launches=warm_launches, voxels_differing=differ,
             max_memory_allocated=peak, gpu=gpu)
        check(ping_at < got[0][2], "the ping waited for the first request")
        check(burst["launches"] == 20 * sum(PIPE_BATCHES.values()),
              f"the burst launched thin_conv3d {burst['launches']} times, expected "
              f"20 x {sum(PIPE_BATCHES.values())}")
        check((burst["load"], burst["build"]) == (1, 1),
              f"the burst loaded {burst['load']} and built {burst['build']} times")
        check(burst["max_waiting"] <= 1, f"{burst['max_waiting']} requests prepared ahead")
        check(not any(differ.values()), f"served masks differ from the pipeline's: {differ}")
        check(warm_launches == 20 * ctx["n_batches"] and n["load"] == 1,
              f"warm request: {warm_launches} launches, {n['load']} loads")
        check(not (warm_mask != ctx["bf16_mask"]).any(),
              "the warm request's mask differs from the main path's")

        # ---- int8, calibrated on the main case: two requests
        sock, th = start("serve_int8", ["-m", model, "--int8", "--int8_calib", ctx["ct"]])
        secs, differ = [], []
        for i in range(2):
            o = os.path.join(ctx["workdir"], f"serve_int8_{i}")
            one = [None]
            timed(sock, o, ctx["ct"], one, 0)
            secs.append(one[0][2] - one[0][1])
            differ.append(int((mask_of(one[0][0], o)[1] != ctx["int8_calib_prob_mask"]).sum()))
        int8 = dict(thin_conv3d=tc.thin_conv3d.launches,
                    window_conv_i8=wi.window_conv_i8.launches, **n)
        stop(sock, th)
        emit("serve", server="int8_calib", request_seconds=secs, counts=int8,
             voxels_differing=differ, gpu=gpu)
        check((int8["load"], int8["build"], int8["calib"]) == (1, 1, 1),
              f"int8 server: load, build, calibration ran "
              f"{(int8['load'], int8['build'], int8['calib'])} times")
        # the stem per batch, and the calibration's one folded forward
        # (calibrate_int8) once per server
        check((int8["thin_conv3d"], int8["window_conv_i8"])
              == (2 * ctx["n_batches"] + 20, 2 * 19 * ctx["n_batches"]),
              f"int8 server launched {int8}")
        check(not any(differ), f"int8 served masks differ from phase_main_int8's: {differ}")

        # ---- coarse-to-fine: one request
        sock, th = start("serve_c2f", ["-m", ctx["coarse"], "--fine_model", model, "--bf16"])
        o = os.path.join(ctx["workdir"], "serve_c2f")
        one = [None]
        timed(sock, o, ctx["ct"], one, 0)
        c2f_counts = dict(launches=tc.thin_conv3d.launches, **n)
        differ = int((mask_of(one[0][0], o)[1] != ctx["c2f_bf16_mask"]).sum())
        stop(sock, th)
        emit("serve", server="c2f_bf16", request_seconds=one[0][2] - one[0][1],
             counts=c2f_counts, voxels_differing=differ, gpu=gpu)
        check(c2f_counts["launches"] == ctx["c2f_launches"],
              f"c2f server launched thin_conv3d {c2f_counts['launches']} times, "
              f"the c2f phase {ctx['c2f_launches']}")
        check(differ == 0, f"the c2f served mask differs in {differ} voxels")
    finally:
        for mod, name, fn in patched:
            setattr(mod, name, fn)
    return ({"seg_serve --bf16 (3-case burst)": burst["launches"],
             "seg_serve --bf16 (warm request)": warm_launches,
             "seg_serve --int8 --int8_calib (stems, calibration)": int8["thin_conv3d"],
             "seg_serve --fine_model --bf16": c2f_counts["launches"]},
            {"seg_serve --int8 --int8_calib": int8["window_conv_i8"]})


#: train_step phase: one SGD step on the card against the CPU's, in float32
#: and in float64. A float32 step is no closer to itself: the CPU's float32
#: step against its float64 one, printed beside them, differs by up to ~4%
#: of a deep tensor's largest update (its gradients are small and pass
#: several BatchNorm backwards, which cancel) and ~0.2% over all updates.
#: The float32 limits sit at about five times the gaps of a sound run on
#: the card; in float64 the same cancellation leaves ~1e-10, so there the
#: card's step must be the CPU's to 1e-8: the same function, not a nearby
STEP_LOSS_RTOL = 1e-4
STEP_UPDATE_TOL = 0.25   # |update difference| / largest update, per tensor
STEP_UPDATE_L2 = 1e-2    # ||update difference|| / ||update||, all tensors
STEP_STATS_TOL = 1e-4    # |BN buffer difference| / largest value, per tensor
STEP_F64_TOL = 1e-8      # every float64 gap above
#: train phase: the mean of the last 4 losses against the first 4
LOSS_FALL = 0.85  # a sound run on an H100: 0.75
#: train phase: val Dice of the folded bf16 forward against the float32
#: nn.Module's on the same checkpoint
VAL_DICE_GAP = 0.02
PEAK_F32_FLOPS = 67e12    # H100 SXM float32 rate outside the tensor cores
DEV = "cuda"              # the card (the train phases only name it here)


def forward_flops(torch, net, shape):
    """Operations of one forward of ``net`` at ``shape`` [B,D,H,W,C]: 2 x
    Cin x Cout x k^3 per output voxel of each conv, per input voxel of each
    transposed conv (the 1 x 1 head projection included), counted from the
    shapes a forward on the card meets."""
    flops = []

    def hook(m, inp, out):
        k = m.weight[0, 0].numel()
        if isinstance(m, torch.nn.ConvTranspose3d):
            flops.append(2 * inp[0].numel() * m.out_channels * k)
        else:
            flops.append(2 * out.numel() * m.in_channels * k)
    hooks = [m.register_forward_hook(hook) for m in net.modules()
             if isinstance(m, (torch.nn.Conv3d, torch.nn.ConvTranspose3d))]
    with torch.no_grad():
        net.eval()(torch.zeros(shape, device=DEV))
    for h in hooks:
        h.remove()
    return sum(flops)


def step_profile(torch, fn, top=12):
    """One call of ``fn`` under ``torch.profiler``: its kernels' device time
    in all, by kind (convolutions, BatchNorm, the rest) and the ``top``
    kernels by their own device time (ms, calls)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for r in prof.key_averages():
        us = getattr(r, "self_device_time_total", None)
        if us is None:
            us = getattr(r, "self_cuda_time_total", 0.0)
        if us and not r.key.startswith("aten::"):  # ops repeat their kernels' time
            rows.append((r.key[:90], us / 1e3, r.count))
    rows.sort(key=lambda t: -t[1])
    by_kind = {"conv": 0.0, "batch_norm": 0.0, "other": 0.0}
    for key, ms, _ in rows:
        k = key.lower()
        kind = "batch_norm" if "batch_norm" in k else "conv" if any(
            s in k for s in ("conv", "gemm", "grad", "cudnn")) else "other"
        by_kind[kind] += ms
    return dict(total_ms=sum(t[1] for t in rows), by_kind_ms=by_kind, top=rows[:top])


def phase_train_step(torch, gpu):
    """One SGD step of a seeded full-width V-Net on one seeded batch (2 x
    64^3, Dice) on the card and on the CPU, in float32 (TF32 off) and in
    float64: the losses, every parameter's update and every BatchNorm
    buffer must agree. Then
    the median step time at batch 8 x 96^3, float32 and bf16."""
    import copy
    import numpy as np
    from segmentation3d_tpu_torch.config import EasyDict
    from segmentation3d_tpu_torch.core.seg_train import train_step
    from segmentation3d_tpu_torch.losses import create_loss
    from segmentation3d_tpu_torch.models.vnet import SegmentationNet, init_like_flax_
    from segmentation3d_tpu_torch.utils.flops import vnet_forward_flops
    loss_fn = create_loss(EasyDict(name="Dice", obj_weight=None), 2)
    net = SegmentationNet(1, 2, remat=True)
    init_like_flax_(net, torch.Generator().manual_seed(5))
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, 64, 64, 64, 1)).astype(np.float32))
    y = torch.from_numpy((rng.random((2, 64, 64, 64)) < 0.3).astype(np.int32))
    results = {}
    for tag, dev, dt in ((DEV, DEV, torch.float32), ("cpu", "cpu", torch.float32),
                         (DEV + "_f64", DEV, torch.float64),
                         ("cpu_f64", "cpu", torch.float64)):
        n = copy.deepcopy(net).to(device=dev, dtype=dt)
        opt = torch.optim.SGD(n.parameters(), lr=0.1)
        t = time.perf_counter()
        loss = float(train_step(n, opt, loss_fn, x.to(dev, dt), y.to(dev)))
        results[tag] = (loss, {k: v.detach().to("cpu", torch.float64)
                               for k, v in n.state_dict().items()},
                        time.perf_counter() - t, np.finfo(str(dt)[6:]).dtype)
        del n, opt
    old = {k: v.double() for k, v in net.state_dict().items()}

    def gaps(a, b):
        """Run ``a`` against run ``b``: the loss gap, the worst per-tensor
        update gap and its tensor, the update L2 gap, the BN buffer gap."""
        (la, sa, _, ft), (lb, sb, _, _) = results[a], results[b]
        upd = stats = 0.0
        worst, num, den = None, 0.0, 0.0
        for k, v in sb.items():
            if k.endswith("num_batches_tracked"):
                continue
            if "running" in k:
                stats = max(stats, float((sa[k] - v).abs().max() / v.abs().max()))
            elif not (k.endswith(".bias") and "bn" not in k and "proj" not in k):
                # conv biases that feed a BatchNorm get no gradient; an
                # update read off the parameters is known to 2 ulp
                d, e = v - old[k], (sa[k] - old[k]) - (v - old[k])
                ulp = 2 * float(np.spacing(ft.type(v.abs().max())))
                g = float((e.abs().max() - ulp) / d.abs().max())
                num, den = num + float((e * e).sum()), den + float((d * d).sum())
                if g > upd:
                    upd, worst = g, k
        return dict(loss_rel_gap=abs(la - lb) / abs(lb), update_gap=upd,
                    update_gap_at=worst, update_l2_gap=(num / den) ** 0.5,
                    bn_buffer_gap=stats)
    f32, f64 = gaps(DEV, "cpu"), gaps(DEV + "_f64", "cpu_f64")
    emit("train_step", loss_cuda=results[DEV][0], loss_cpu=results["cpu"][0],
         **f32, max_loss_rel_gap=STEP_LOSS_RTOL, max_update_gap=STEP_UPDATE_TOL,
         max_update_l2_gap=STEP_UPDATE_L2, max_bn_buffer_gap=STEP_STATS_TOL,
         float64=f64, max_float64_gap=STEP_F64_TOL,
         cpu_f32_vs_f64=gaps("cpu", "cpu_f64"),
         cuda_f32_vs_f64=gaps(DEV, "cpu_f64"),
         seconds={k: r[2] for k, r in results.items()},
         cpu_count=os.cpu_count(), gpu=gpu)
    check(f32["loss_rel_gap"] <= STEP_LOSS_RTOL, f"train step loss gap {f32}")
    check(f32["update_gap"] <= STEP_UPDATE_TOL, f"train step update gap {f32}")
    check(f32["update_l2_gap"] <= STEP_UPDATE_L2, f"train step update L2 gap {f32}")
    check(f32["bn_buffer_gap"] <= STEP_STATS_TOL, f"train step BN buffer gap {f32}")
    check(max(v for k, v in f64.items() if k != "update_gap_at") <= STEP_F64_TOL,
          f"float64 train step on the card vs the CPU {f64}")

    # step time at the train phase's batch: 8 x 96^3, Adam, both dtypes
    xb = torch.randn(BATCH, PATCH, PATCH, PATCH, 1, device=DEV)
    yb = (torch.rand(BATCH, PATCH, PATCH, PATCH, device=DEV) < 0.3).to(torch.int32)
    timing = {}
    fwd = forward_flops(torch, net.to(DEV), (1, PATCH, PATCH, PATCH, 1))
    analytic = vnet_forward_flops((PATCH,) * 3, 1, 2)
    check(fwd == analytic, f"forward FLOPs by hooks {fwd} != utils/flops.py's {analytic}")
    step_flops = 3 * fwd * BATCH  # forward + the backward's two products
    for name, dt, peak in (("float32", torch.float32, PEAK_F32_FLOPS),
                           ("bfloat16", torch.bfloat16, PEAK_BF16_FLOPS)):
        n = copy.deepcopy(net).to(DEV)
        opt = torch.optim.Adam(n.parameters(), lr=1e-3)
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(7):
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = train_step(n, opt, loss_fn, xb, yb, dtype=dt)
            check(bool(torch.isfinite(loss)), f"{name} step: non-finite loss")
            torch.cuda.synchronize()
            if i >= 2:  # after two warm-up steps
                times.append(time.perf_counter() - t)
        ms = 1e3 * float(np.median(times))
        timing[name] = dict(median_ms=ms, step_ms=[1e3 * t for t in times],
                            crops_per_s=BATCH / ms * 1e3,
                            bound_ms=step_flops / peak * 1e3, bound_by="operations",
                            peak_memory=torch.cuda.max_memory_allocated(),
                            device_time=step_profile(torch, lambda: train_step(
                                n, opt, loss_fn, xb, yb, dtype=dt)))
        del n, opt
        torch.cuda.empty_cache()
    emit("train_step_time", batch=BATCH, crop=PATCH, forward_gflop_per_crop=fwd / 1e9,
         utils_flops_gflop_per_crop=analytic / 1e9,
         step_tflop=step_flops / 1e12, remat=True, **timing, gpu=gpu)
    return timing


def label_case(path_img, path_seg, seed, slices=160):
    """A CT-like int16 case of 256 x 256 x ``slices`` voxels at 0.8 x 0.8 x
    1.5 mm (:func:`phantom_hu`, its centre moved by up to 10 mm per seed)
    and its label as uint8: the two dense organs of the noiseless phantom
    (100 to 300 HU: spheres of 35 and 20 mm radius, not the soft tissue
    around them, fat, lung or bone). Returns the label."""
    import numpy as np
    from segmentation3d_tpu_torch.io import Volume, write_image
    from segmentation3d_tpu_torch.ops.geometry import Frame
    rng = np.random.default_rng(seed)
    sp = np.array([0.8, 0.8, 1.5])
    shift = rng.uniform(-10, 10, 3)
    z, y, x = ((np.arange(n) - n / 2) * d + o for n, d, o in
               ((slices, sp[2], shift[0]), (256, sp[1], shift[1]),
                (256, sp[0], shift[2])))
    clean = phantom_hu(z, y, x, rng, noise=0.0)
    seg = ((clean >= 100) & (clean < 300)).astype(np.uint8)
    frame = Frame.identity(spacing=sp)
    write_image(Volume(phantom_hu(z, y, x, rng), frame), path_img)
    write_image(Volume(seg, frame), path_seg)
    return seg


TRAIN_CONFIG = """from easydict import EasyDict as edict
from segmentation3d.utils.normalizer import FixedNormalizer, AdaptiveNormalizer

__C = edict()
cfg = __C
__C.general = edict()
__C.general.imseg_list = r"{train}"
__C.general.save_dir = r"{save_dir}"
__C.general.resume_epoch = -1
__C.general.num_gpus = 1
__C.general.seed = 0
__C.dataset = edict()
__C.dataset.num_modality = 1
__C.dataset.num_classes = 2
__C.dataset.spacing = [1.0, 1.0, 1.0]
__C.dataset.crop_size = [{crop}, {crop}, {crop}]
__C.dataset.sampling_method = "MASK"
__C.dataset.random_translation = [5.0, 5.0, 5.0]
__C.dataset.interpolation = "LINEAR"
__C.dataset.crop_normalizers = [FixedNormalizer(mean=40.0, stddev=400.0, clip=True)]
__C.dataset.random_flip = True
__C.loss = edict()
__C.loss.name = "Dice"
__C.loss.obj_weight = None
__C.loss.focal_obj_alpha = 0.25
__C.loss.focal_gamma = 2.0
__C.net = edict()
__C.net.name = "vnet"
__C.train = edict()
__C.train.epochs = {epochs}
__C.train.batchsize = {batch}
__C.train.num_threads = 2
__C.train.lr = 1e-3
__C.train.betas = (0.9, 0.999)
__C.train.save_epochs = {save_epochs}
__C.train.val_list = r"{val}"
__C.train.save_best = True
__C.debug = edict()
__C.debug.save_inputs = False
__C.tpu = edict()
__C.tpu.dtype = "bfloat16"
__C.tpu.remat = True
__C.tpu.mesh = edict()
__C.tpu.mesh.data = -1
__C.tpu.steps_per_dispatch = 1
"""
TRAIN_CASES, TRAIN_STEPS = 4, 32


def phase_train(torch, tc, wi, workdir, gpu):
    """``seg_train`` as a user runs it: four seeded CT-like cases, a
    validation case, the template's config format, bf16, 32 steps of batch
    8 x 96^3, two save points with validation through the folded forward."""
    import csv
    import numpy as np
    from segmentation3d_tpu_torch.cli.seg_infer import main as seg_infer
    from segmentation3d_tpu_torch.cli.seg_train import main as seg_train
    from segmentation3d_tpu_torch.core.seg_train import train
    from segmentation3d_tpu_torch.core.validation import validate_cases
    from segmentation3d_tpu_torch.core.seg_infer import load_seg_model
    from segmentation3d_tpu_torch.io import read_image
    t = time.perf_counter()
    d = os.path.join(workdir, "train")
    os.makedirs(d)
    lines, fg = [str(TRAIN_CASES)], []
    for i in range(TRAIN_CASES):
        img, seg = (os.path.join(d, f"case{i}_{k}.nii.gz") for k in ("ct", "seg"))
        fg.append(float(label_case(img, seg, seed=10 + i).mean()))
        lines += [img, seg]
    train_txt = os.path.join(d, "train.txt")
    with open(train_txt, "w") as f:
        f.write("\n".join(lines) + "\n")
    val_img, val_seg = (os.path.join(d, f"val_{k}.nii.gz") for k in ("ct", "seg"))
    label_case(val_img, val_seg, seed=20)
    val_txt = os.path.join(d, "val.txt")
    with open(val_txt, "w") as f:
        f.write(f"1\n{val_img}\n{val_seg}\n")
    save_dir = os.path.join(d, "model")
    ctx = dict(train=train_txt, val=val_txt, save_dir=save_dir, dir=d)
    # epoch = batch x 8 / 4 cases: 32 steps reach epoch 64, saves at 32, 64
    epochs = TRAIN_STEPS * BATCH // TRAIN_CASES
    cfg = os.path.join(d, "config.py")
    with open(cfg, "w") as f:
        f.write(TRAIN_CONFIG.format(train=train_txt, save_dir=save_dir, val=val_txt,
                                    epochs=epochs, save_epochs=epochs // 2,
                                    crop=PATCH, batch=BATCH))
    setup = time.perf_counter() - t

    stats = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the training path: counts reset just before, read just after
    tc.thin_conv3d.launches = 0
    wi.window_conv_i8.launches = 0
    t0 = time.perf_counter()
    train(cfg, stats=stats)
    wall = time.perf_counter() - t0
    launches = (tc.thin_conv3d.launches, wi.window_conv_i8.launches)
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(save_dir, "train_loss.csv")) as f:
        losses = [float(r["loss"]) for r in csv.DictReader(f)]
    with open(os.path.join(save_dir, "val_dice.csv")) as f:
        val_rows = list(csv.DictReader(f))
    n_val = len(val_rows)
    first, last = float(np.mean(losses[:4])), float(np.mean(losses[-4:]))
    # steady state: from the first loss readback (step 8: the cold start,
    # the cases' first read, is behind it) to the last, save points out
    (s0, t0f, w0), (s1, t1f, w1) = stats["flushes"][0], stats["flushes"][-1]
    span = t1f - t0f - sum(stats["save_point_seconds"][:-1])
    crops_s = (s1 - s0) * BATCH / span
    wait_share = (w1 - w0) / span

    # the last checkpoint's val Dice through the float32 nn.Module
    model = load_seg_model(save_dir, torch.device(DEV))
    dice_f32 = validate_cases(
        model.net, val_txt, spacing=model.spacing, interpolation="LINEAR",
        normalizers=model.normalizers, num_classes=2,
        max_stride=model.max_stride, dtype=torch.float32)[0]
    dice_bf16 = float(val_rows[-1]["val_dice"])
    # chk_best and the last checkpoint through seg_infer --bf16
    masks = {}
    for which in ("best", "latest"):
        out = os.path.join(d, f"infer_{which}")
        res = seg_infer(["-i", val_img, "-m", save_dir, "-o", out, "--bf16",
                         "--checkpoint", which])
        mask = read_image(os.path.join(out, res[0][0], "seg.mha")).data
        gt = read_image(val_seg).data
        masks[which] = dict(shape=list(mask.shape), foreground=float(mask.mean()),
                            dice_vs_label=float(2 * np.sum((mask == 1) & (gt == 1))
                                                / max(1, np.sum(mask == 1) + np.sum(gt == 1))))
        check(mask.shape == gt.shape, f"seg_infer --checkpoint {which}: mask shape")
    # the CLI's rules on the card: --fold needs --folds
    try:
        seg_train(["-i", cfg, "--fold", "0"])
        cli_refused = False
    except SystemExit:
        cli_refused = True
    emit("train", cases=TRAIN_CASES, label_fraction=fg, steps=stats["steps"],
         losses=losses, first4=first, last4=last, max_last_over_first=LOSS_FALL,
         launches=dict(thin_conv3d=launches[0], window_conv_i8=launches[1]),
         validation_forwards=n_val, val_dice_bf16_folded=dice_bf16,
         val_dice_f32_module=dice_f32, max_val_dice_gap=VAL_DICE_GAP,
         val_rows=val_rows, crops_per_s=crops_s, steady_steps=s1 - s0,
         loop_seconds=stats["loop_seconds"], prefetch_wait_share=wait_share,
         prefetch_wait_share_with_cold_start=(
             stats["prefetch_wait_seconds"] / stats["loop_seconds"]),
         save_point_seconds=stats["save_point_seconds"],
         validation_seconds=stats["validation_seconds"], wall_seconds=wall,
         setup_seconds=setup, max_memory_allocated=peak, infer=masks, gpu=gpu)
    check(len(losses) == stats["steps"] == TRAIN_STEPS,
          f"{len(losses)} loss rows, {stats['steps']} steps")
    check(all(np.isfinite(losses)), "non-finite training loss")
    check(last <= LOSS_FALL * first, f"loss did not fall: {first} -> {last}")
    check(n_val == 2, f"{n_val} validation rows, expected 2")
    check(launches == (20 * n_val, 0),
          f"training launched (thin_conv3d, window_conv_i8) {launches}, "
          f"expected ({20 * n_val}, 0)")
    check(abs(dice_bf16 - dice_f32) <= VAL_DICE_GAP,
          f"val Dice bf16 folded {dice_bf16} vs f32 module {dice_f32}")
    check(os.path.isfile(os.path.join(save_dir, "checkpoints", "chk_best", "params.pth")),
          "no chk_best")
    check(cli_refused, "--fold without --folds was not refused")
    return launches[0], ctx


#: train_ddp phase: the two-rank step against the one-rank step at full size,
#: float32 (TF32 off). Loss and running statistics: the bars of
#: tests/test_torch_port_train_step.py. Updates: the train_step phase's bars
#: (per tensor, and L2 over all), since float32 rounding through the
#: BatchNorm backwards moves a deep tensor's update by a few percent of its
#: largest element between two orders of the same sums (on the CPU at 32^3:
#: 4.8%, L2 5e-4), beyond that file's 1e-3, which holds for its small nets
DDP_LOSS_RTOL = 1e-5
DDP_STATS_TOL = 1e-5      # |running stat difference| / the tensor's largest value
#: ... and in float64 at 64^3, where rounding leaves ~1e-13: the same function
DDP_F64_TOL = 1e-8
DDP_STEPS = 8             # the loop: 8 steps of 4 x 96^3 per rank, 2 save points
THIN_TOL = 0.05           # the kernel phase's bar: of the plain output's largest value
DDP_TIMEOUT = datetime.timedelta(seconds=300)  # a collective's longest wait

RANK1_SCRIPT = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
print(json.dumps(chip_smoke.rank1_main(*sys.argv[2:])))
"""


def step_gaps(torch, got, want, old, ft):
    """Two steps' results (state dicts, float64 on the host) against each
    other: the worst running-statistic gap over the tensor's largest value,
    the worst update gap over the tensor's largest update (beyond 2 ulp of
    the parameter, of type ``ft``) and its tensor, the update L2 gap."""
    import numpy as np
    stats = upd = num = den = 0.0
    worst = None
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        if "running" in k:
            stats = max(stats, float((got[k] - v).abs().max() / v.abs().max()))
        elif not (k.endswith(".bias") and "bn" not in k and "proj" not in k):
            # conv biases that feed a BatchNorm get no gradient
            d, e = v - old[k], got[k] - v
            ulp = 2 * float(np.spacing(ft(v.abs().max())))
            g = float((e.abs().max() - ulp) / d.abs().max())
            num, den = num + float((e * e).sum()), den + float((d * d).sum())
            if g > upd:
                upd, worst = g, k
    return dict(bn_buffer_gap=stats, update_gap=upd, update_gap_at=worst,
                update_l2_gap=(num / den) ** 0.5)


def ddp_net(torch, seed, dtype):
    from segmentation3d_tpu_torch.models.vnet import SegmentationNet, init_like_flax_
    net = SegmentationNet(1, 2, remat=True)
    init_like_flax_(net, torch.Generator().manual_seed(seed))
    return net.to(DEV, dtype)


def ddp_batch(torch, batch, crop, dtype):
    import numpy as np
    rng = np.random.default_rng(batch * 1000 + crop)
    x = rng.normal(size=(batch, crop, crop, crop, 1))
    y = (rng.random((batch, crop, crop, crop)) < 0.3).astype(np.int32)
    return torch.from_numpy(x).to(dtype), torch.from_numpy(y)


def ddp_setup(torch, rank, data, spatial, batch, crop, dtype, group):
    """The seeded full-width V-Net (with ``group``: under DDP over the
    (data, spatial) mesh of the current group, with synced BatchNorm and
    halo convs), its loss (Dice over the z slabs) and this rank's rows and
    planes of a seeded global batch: ``(net, model, loss_fn, x, y)``."""
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel
    from segmentation3d_tpu_torch.config import EasyDict
    from segmentation3d_tpu_torch.losses import create_loss
    from segmentation3d_tpu_torch.models.vnet import distribute_
    from segmentation3d_tpu_torch.parallel.train_mesh import TrainMesh
    net = ddp_net(torch, 7, dtype)
    x, y = ddp_batch(torch, batch, crop, dtype)
    mesh = TrainMesh(data, spatial, rank)
    model, z_group = net, None
    if group:
        z_group = mesh.spatial_group()
        distribute_(net, dist.group.WORLD, z_group)
        model = DistributedDataParallel(net, device_ids=[0], broadcast_buffers=False)
    rows, z = mesh.local_rows(batch), mesh.local_z(crop)
    loss_fn = create_loss(EasyDict(name="Dice", obj_weight=None), 2, z_group=z_group)
    return net, model, loss_fn, x[rows][:, z].to(DEV), y[rows][:, z].to(DEV)


def ddp_step(torch, rank, data, spatial, batch, crop, dtype, group=True):
    """One SGD step (TF32 off) of :func:`ddp_setup`'s net on its batch
    (``group=False``: one rank, ``data = spatial = 1``). Returns the global
    loss, the state dict after the step (float64, host), the step's seconds
    and this rank's peak memory."""
    from segmentation3d_tpu_torch.core.seg_train import train_step
    from segmentation3d_tpu_torch.parallel.collectives import world_mean
    net, model, loss_fn, x, y = ddp_setup(torch, rank, data, spatial, batch, crop,
                                          dtype, group)
    opt = torch.optim.SGD(net.parameters(), lr=0.1)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    loss = float(world_mean(train_step(model, opt, loss_fn, x, y)))
    seconds = time.perf_counter() - t
    state = {k: v.detach().to("cpu", torch.float64) for k, v in net.state_dict().items()}
    return loss, state, seconds, torch.cuda.max_memory_allocated()


def ranks_spread(torch, state):
    """The largest difference of any state element between the two ranks."""
    import torch.distributed as dist
    flat = torch.cat([v.flatten() for v in state.values()]).to(DEV)
    hi, lo = flat.clone(), flat.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    return float((hi - lo).max())


def ddp_timing(torch, rank, data, spatial, batch, crop, reps=3):
    """Median bf16 step milliseconds of this rank over ``reps`` steps after
    one warm-up, with the collectives (DDP, synced BatchNorm, halo) and then
    without (each rank alone on the same shapes), both ranks started
    together by a barrier before each step."""
    import numpy as np
    import torch.distributed as dist
    from segmentation3d_tpu_torch.core.seg_train import train_step
    out = {}
    for tag, group in (("with_collectives", True), ("without", False)):
        net, model, loss_fn, x, y = ddp_setup(torch, rank, data, spatial, batch, crop,
                                              torch.float32, group)
        opt = torch.optim.Adam(net.parameters(), lr=1e-3)
        times = []
        for i in range(reps + 1):
            dist.barrier()
            torch.cuda.synchronize()
            t = time.perf_counter()
            train_step(model, opt, loss_fn, x, y, dtype=torch.bfloat16)
            torch.cuda.synchronize()
            if i:
                times.append(time.perf_counter() - t)
        out[tag + "_ms"] = 1e3 * float(np.median(times))
        del model, net, opt
        torch.cuda.empty_cache()
    return out


def ddp_steps(torch, rank):
    """Rank ``rank``'s part of (a) and (b), in the current group of two:
    each scenario's checked steps (float64 at 64^3, float32 at 96^3) and
    its bf16 timing. Returns, per scenario, what rank 0 checks."""
    res = {}
    for tag, (data, spatial, batch, batch64) in DDP_MESHES.items():
        r = {}
        for dt, crop, b in ((torch.float64, 64, batch64), (torch.float32, PATCH, batch)):
            loss, state, sec, peak = ddp_step(torch, rank, data, spatial, b, crop, dt)
            r[str(dt)[6:]] = dict(loss=loss, state=state, seconds=sec, peak=peak,
                                  ranks_spread=ranks_spread(torch, state))
        r["bf16_timing"] = ddp_timing(torch, rank, data, spatial, batch, PATCH)
        res[tag] = r
    return res


#: (a) and (b): (data, spatial, global batch at 96^3, at 64^3 in float64)
DDP_MESHES = {"a_data2": (2, 1, BATCH, 2), "b_spatial2": (1, 2, BATCH // 2, 1)}


def torchrun_env(rank, port):
    return dict(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))


def loop_result(torch, stats):
    """A rank's numbers from ``train_ranks``'s stats: steady step ms (from
    the first loss readback to the last, save points out)."""
    (s0, t0, _), (s1, t1, _) = stats["flushes"][0], stats["flushes"][-1]
    span = t1 - t0 - sum(stats["save_point_seconds"][:-1])
    return dict(steps=stats["steps"], steady_steps=s1 - s0,
                step_ms=1e3 * span / max(1, s1 - s0),
                save_point_seconds=stats["save_point_seconds"],
                peak_memory=torch.cuda.max_memory_allocated())


def rank1_main(port_steps, config, port_loop):
    """The helper process: rank 1 of (a) and (b) in a group with this
    script's process, then rank 1 of ``seg_train``'s torchrun group for
    (c). Prints what rank 0 checks beside its own."""
    import torch
    import torch.distributed as dist
    from segmentation3d_tpu_torch.core.seg_train import train_ranks
    from segmentation3d_tpu_torch.ops import thin_conv as tc
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port_steps}",
                            rank=1, world_size=2, timeout=DDP_TIMEOUT)
    torch.cuda.set_device(0)
    steps = ddp_steps(torch, 1)
    dist.destroy_process_group()
    torch.cuda.reset_peak_memory_stats()
    os.environ.update(torchrun_env(1, port_loop))
    stats = {}
    tc.thin_conv3d.launches = 0
    train_ranks(config, 0, stats)
    for r in steps.values():  # rank 0 checks the states through ranks_spread
        for dt in ("float64", "float32"):
            del r[dt]["state"]
    return dict(steps=steps, loop=loop_result(torch, stats),
                launches=tc.thin_conv3d.launches)


def watchdog(proc, err):
    """End this process (exit 1) if ``proc`` fails while this one may be
    waiting for it in a collective; set the returned event before ending
    ``proc`` on purpose."""
    import threading
    stopping = threading.Event()

    def watch():
        if proc.wait() != 0 and not stopping.is_set():
            err.seek(0)
            print(f"chip_smoke: FAILED: rank 1 exited {proc.returncode}: "
                  f"{err.read()[-3000:]}", file=sys.stderr, flush=True)
            os._exit(1)
    threading.Thread(target=watch, daemon=True).start()
    return stopping


def phase_train_ddp(torch, tc, wi, train_ctx, gpu):
    """Two training ranks on the one card over gloo: (a) and (b), one step
    each against one rank, then (c) ``seg_train`` as two torchrun ranks."""
    import csv
    import torch.distributed as dist
    import segmentation3d_tpu_torch.models.fused_vnet as fused
    from segmentation3d_tpu_torch.core.seg_train import train_ranks
    from segmentation3d_tpu_torch.parallel import distributed
    from segmentation3d_tpu_torch.utils import model_io
    d = os.path.join(train_ctx["dir"], "ddp")
    os.makedirs(d)
    save_dir = os.path.join(d, "model")
    epochs = DDP_STEPS * BATCH // TRAIN_CASES
    cfg = os.path.join(d, "config.py")
    with open(cfg, "w") as f:
        f.write(TRAIN_CONFIG.format(train=train_ctx["train"], save_dir=save_dir,
                                    val=train_ctx["val"], epochs=epochs,
                                    save_epochs=epochs // 2, crop=PATCH, batch=BATCH)
                + "__C.tpu.log_every = 1\n")
    rule = distributed.training_rule(2, torch.cuda.device_count(), 0)
    rule = dict(backend=rule[0], devices=[str(x) for x in rule[1]])

    # the one-rank steps, before any group
    one = {tag: {str(dt)[6:]: ddp_step(torch, 0, 1, 1, b, crop, dt, group=False)
                 for dt, crop, b in ((torch.float64, 64, batch64),
                                     (torch.float32, PATCH, batch))}
           for tag, (_, _, batch, batch64) in DDP_MESHES.items()}
    port_steps, port_loop = free_port(), free_port()
    logs = [open(os.path.join(d, f"rank1.{k}"), "w+") for k in ("out", "err")]
    helper = subprocess.Popen(
        [sys.executable, "-c", RANK1_SCRIPT, HERE, str(port_steps), cfg, str(port_loop)],
        stdout=logs[0], stderr=logs[1], text=True)
    stopping = watchdog(helper, logs[1])
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port_steps}",
                                rank=0, world_size=2, timeout=DDP_TIMEOUT)
        mine = ddp_steps(torch, 0)
        backend = dist.get_backend()
        dist.destroy_process_group()

        # (c): seg_train's own start under torchrun's environment, this
        # process as rank 0; every thin_conv3d launch also runs its plain
        # version (not counted) for the comparison
        errs = []
        real = fused.thin_conv3d

        def held(x, w, b=None, **kw):
            out = real(x, w, b, **kw)
            ref = tc.thin_conv3d_reference(x, w, b, **kw)
            errs.append((float((out.float() - ref.float()).abs().max()),
                         float(ref.float().abs().max())))
            return out
        saved_env = {k: os.environ.get(k) for k in torchrun_env(0, 0)}
        os.environ.update(torchrun_env(0, port_loop))
        fused.thin_conv3d = held
        stats = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tc.thin_conv3d.launches = 0
        wi.window_conv_i8.launches = 0
        t = time.perf_counter()
        try:
            train_ranks(cfg, 0, stats)
        finally:
            fused.thin_conv3d = real
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        wall = time.perf_counter() - t
        launches = (tc.thin_conv3d.launches, wi.window_conv_i8.launches)
        loop0 = loop_result(torch, stats)
        helper.wait(timeout=600)
    finally:
        stopping.set()
        helper.kill()
        helper.wait()
        so, se = (f.seek(0) or f.read() for f in logs)
        for f in logs:
            f.close()
    check(helper.returncode == 0, f"rank 1 exited {helper.returncode}: {se.strip()[-3000:]}")
    other = json.loads(so.strip().splitlines()[-1])

    import numpy as np
    old = {k: v.to("cpu", torch.float64)
           for k, v in ddp_net(torch, 7, torch.float32).state_dict().items()}
    scen = {}
    for tag in DDP_MESHES:
        r = {}
        for dt in ("float64", "float32"):
            loss1, want, _, _ = one[tag][dt]
            m = mine[tag][dt]
            r[dt] = dict(loss_one_rank=loss1, loss_two_ranks=m["loss"],
                         loss_rel_gap=abs(m["loss"] - loss1) / abs(loss1),
                         ranks_spread=m["ranks_spread"],
                         **step_gaps(torch, m["state"], want, old, getattr(np, dt)),
                         seconds=dict(one_rank=one[tag][dt][2], rank0=m["seconds"],
                                      rank1=other["steps"][tag][dt]["seconds"]),
                         peak_memory=dict(one_rank=one[tag][dt][3], rank0=m["peak"],
                                          rank1=other["steps"][tag][dt]["peak"]))
        t0, t1 = mine[tag]["bf16_timing"], other["steps"][tag]["bf16_timing"]
        r["bf16_step_ms"] = dict(rank0=t0, rank1=t1, collectives_share=[
            1 - t["without_ms"] / t["with_collectives_ms"] for t in (t0, t1)])
        scen[tag] = r
    with open(os.path.join(save_dir, "train_loss.csv")) as f:
        losses = [float(row["loss"]) for row in csv.DictReader(f)]
    with open(os.path.join(save_dir, "val_dice.csv")) as f:
        n_val = len(list(csv.DictReader(f)))
    chk = model_io.latest_checkpoint(save_dir)
    keys = list(model_io.load_checkpoint_payload(chk)["state_dict"])
    keys_one = list(model_io.load_checkpoint_payload(
        model_io.latest_checkpoint(train_ctx["save_dir"]))["state_dict"])
    loop1 = other["loop"]
    pair_crops_s = BATCH / (max(loop0["step_ms"], loop1["step_ms"]) / 1e3)
    emit("train_ddp", rule=rule, backend=backend, world=2, scenarios=scen,
         bars=dict(loss_rtol=DDP_LOSS_RTOL, bn_buffer=DDP_STATS_TOL,
                   update=STEP_UPDATE_TOL, update_l2=STEP_UPDATE_L2, float64=DDP_F64_TOL),
         loop=dict(rank0=loop0, rank1=loop1, crops_per_s_pair=pair_crops_s,
                   wall_seconds=wall, losses=losses, validation_forwards=n_val,
                   launches=dict(thin_conv3d=launches[0], window_conv_i8=launches[1],
                                 rank1_thin_conv3d=other["launches"]),
                   thin_conv3d_max_err=max(e for e, _ in errs) if errs else None,
                   thin_conv3d_max_err_over_largest_output=max(
                       e / m for e, m in errs) if errs else None,
                   thin_conv3d_tol_over_largest_output=THIN_TOL,
                   checkpoint=os.path.basename(chk)),
         gpu=gpu)
    check(rule == dict(backend="gloo", devices=["cuda:0", "cuda:0"]) and backend == "gloo",
          f"two ranks on one card: rule {rule}, backend {backend}")
    for tag, r in scen.items():
        f64, f32 = r["float64"], r["float32"]
        for dt in ("float64", "float32"):
            check(r[dt]["ranks_spread"] == 0.0, f"{tag} {dt}: ranks differ {r[dt]['ranks_spread']}")
        check(max(f64["loss_rel_gap"], f64["bn_buffer_gap"], f64["update_gap"])
              <= DDP_F64_TOL, f"{tag} float64 two ranks vs one: {f64}")
        check(f32["loss_rel_gap"] <= DDP_LOSS_RTOL, f"{tag} float32 loss gap {f32}")
        check(f32["bn_buffer_gap"] <= DDP_STATS_TOL, f"{tag} float32 BN buffer gap {f32}")
        check(f32["update_gap"] <= STEP_UPDATE_TOL and f32["update_l2_gap"] <= STEP_UPDATE_L2,
              f"{tag} float32 update gap {f32}")
    check(len(losses) == DDP_STEPS and all(map(math.isfinite, losses)),
          f"train_loss.csv rows {losses}")
    check(keys == keys_one, "the two-rank checkpoint's keys differ from the one-rank run's")
    check(n_val == 2 and launches == (20 * n_val, 0) and other["launches"] == 0,
          f"validation rows {n_val}, launches rank 0 {launches}, rank 1 {other['launches']}")
    check(len(errs) == launches[0] and all(e <= THIN_TOL * m for e, m in errs),
          f"thin_conv3d against its plain version in the loop: {errs}")
    return launches[0]


def train_only(torch):
    """Build the kernels, then phases train and train_ddp alone."""
    from segmentation3d_tpu_torch.ops import cuda_build
    from segmentation3d_tpu_torch.ops import thin_conv as tc
    from segmentation3d_tpu_torch.ops import window_i8 as wi
    gpu = gpu_line()
    print(gpu)
    cuda_build.build_all()
    with tempfile.TemporaryDirectory() as workdir:
        _, train_ctx = phase_train(torch, tc, wi, workdir, gpu)
        phase_train_ddp(torch, tc, wi, train_ctx, gpu)
    return 0


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
    if "--train-only" in sys.argv[1:]:
        return train_only(torch)
    from segmentation3d_tpu_torch import native
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
    # the host codec (g++), before any read or write uses it
    t = time.perf_counter()
    codec = native.codec()
    emit("codec_build", status=codec.status, seconds=time.perf_counter() - t,
         library=codec.path and os.path.relpath(codec.path, HERE),
         libdeflate=codec.has_gzip)
    check(codec.lib is not None, f"the host codec did not build: {codec.status}")

    sites = phase_kernels(torch, tc)
    sites_i8 = phase_kernels_i8(torch, wi)
    with tempfile.TemporaryDirectory() as workdir:
        ctx = phase_main(torch, tc, workdir, gpu)
        launches_formats = phase_formats(torch, tc, ctx, gpu)
        launches_i8 = phase_main_int8(torch, tc, wi, ctx, gpu)
        phase_pipeline(torch, tc, ctx, gpu)
        launches_shard, launches_shard_i8 = phase_shard(torch, tc, wi, ctx, gpu)
        phase_ensemble(torch, tc, ctx, gpu)
        phase_tta(torch, tc, ctx, gpu)
        phase_c2f(torch, tc, wi, ctx, gpu)
        launches_vbnet = phase_vbnet(torch, tc, wi, ctx, gpu)
        launches_convert = phase_convert(torch, tc, ctx, gpu)
        launches_serve, launches_serve_i8 = phase_serve(torch, tc, wi, ctx, gpu)
        phase_train_step(torch, gpu)
        launches_train, train_ctx = phase_train(torch, tc, wi, workdir, gpu)
        launches_ddp = phase_train_ddp(torch, tc, wi, train_ctx, gpu)

    thin_paths = {"seg_infer --bf16": ctx["launches"], **launches_formats,
                  **launches_shard, **launches_vbnet, **launches_convert,
                  **launches_serve,
                  "seg_train (validation)": launches_train,
                  "seg_train, 2 ranks (rank 0's validation)": launches_ddp}
    thin = kernel_entry("thin_conv3d", "segmentation3d_tpu_torch/csrc/thin_conv3d.cu",
                        "segmentation3d_tpu/ops/pallas_conv.py:174",
                        sum(thin_paths.values()), sites, PEAK_BF16_FLOPS, "flops")
    thin["launches_by_path"] = thin_paths
    i8_paths = {"seg_infer --int8": launches_i8, **launches_shard_i8,
                **launches_serve_i8}
    i8 = kernel_entry("window_conv_i8", "segmentation3d_tpu_torch/csrc/window_conv_i8.cu",
                      "segmentation3d_tpu/ops/pallas_i8win.py:144",
                      sum(i8_paths.values()), sites_i8, PEAK_INT8_OPS, "ops")
    i8["launches_by_path"] = i8_paths
    print(gpu)
    print(json.dumps({"kernels": [
        # 20 launches per bf16 forward: the main path (NIfTI, DICOM and NRRD
        # input, toolkit and converted checkpoints, served requests), the
        # training path's validation; 16 per VB-Net forward; the epilogue
        # variants' errors (int8 in steps) are on their own "kernel" lines
        thin,
        # 19 launches per int8 forward: the int8 main path, served requests
        i8,
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
