#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``segmentation3d_tpu_torch``) on one
NVIDIA GPU:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: compiles the hand-written kernel (``csrc/thin_conv3d.cu``) with
   nvcc for sm_90a;
3. kernels: holds ``thin_conv3d`` against its plain PyTorch version at every
   conv site of the bf16 V-Net forward (96^3 patches, batch 8, full width)
   and times the kernel, the plain version, a cuDNN yardstick and the bound;
4. main path: ``seg_infer --bf16 --partition_type SIZE`` on a seeded
   512x512x240 CT-like volume with a seeded full-width V-Net, counting the
   kernel's launches; then the same case through the float32 ``nn.Module``
   forward. The net's BatchNorm statistics are taken from phantom patches
   and its head is biased so that about half of the body is foreground, so
   the mask depends on the forward: the two masks must agree on >= 98% of
   voxels, with a foreground Dice and a largest probability gap within
   limits.

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
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 rate
BATCH, PATCH = 8, 96
AGREE_MIN = 0.98          # bf16 vs f32 mask agreement (tests/test_pallas_conv.py)
# bf16 vs f32 foreground Dice and largest probability gap: about twice the
# gaps of a sound forward of this seeded case on an H100 (Dice 0.9968, gap
# 0.0295), so a BN fold with eps 1e-3 instead of 1e-5 already fails
DICE_MIN = 0.99
DPROB_MAX = 0.06
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
        dict(name="prelu+prelu tail", size=PATCH // 2, cin=32, cout=32,
             act="prelu", residual="prelu", out=torch.bfloat16, per_forward=0),
        dict(name="f32 out", size=PATCH // 4, cin=64, cout=64, act="relu",
             residual="none", out=torch.float32, per_forward=0),
        dict(name="int8 out", size=PATCH // 2, cin=32, cout=32, act="relu",
             residual="relu", out=torch.int8, per_forward=0),
    ]
    results = []
    for c in cases:
        s, ci, co = c["size"], c["cin"], c["cout"]
        x = torch.randn(BATCH, s, s, s, ci, device=dev, generator=g)
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
        vox = BATCH * s ** 3
        out_bytes = {torch.bfloat16: 2, torch.float32: 4, torch.int8: 1}[c["out"]]
        nbytes = vox * ci * 2 + vox * co * out_bytes + 27 * ci * co * 2 + co * 4
        flops = 2 * 27 * ci * co * vox
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
        r = dict(site=c["name"], shape=[BATCH, s, s, s, ci], cout=co,
                 act=c["act"], residual=c["residual"],
                 out=str(c["out"]).replace("torch.", ""),
                 path=tc.kernel_path(ci, co), per_forward=c["per_forward"],
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
    (fat, soft tissue), organs, a spine, noise."""
    import numpy as np
    zz, yy, xx = np.meshgrid(z, y, x, indexing="ij", sparse=True)
    body2d = ((xx / 160.0) ** 2 + (yy / 110.0) ** 2)[0]
    img = np.full((len(z), len(y), len(x)), -1000, np.int16)
    img[:, body2d < 1.0] = -100
    img[:, body2d < 0.8] = 40
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
    would leave them, and bias its head so that half of the patches' body
    voxels are foreground. A random net's head otherwise leaves most voxels
    at one constant logit, and a mask check on it is vacuous."""
    import numpy as np
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
    with torch.no_grad():
        net.out_block.conv.bn.bias.fill_(1.0)  # keep the head's relu live
        logits = net(x, return_logits=True)
        logodds = (logits[..., 1] - logits[..., 0])[torch.from_numpy(hu > -500)]
        net.out_block.proj.bias[1] -= logodds.median()
    return net


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
    agree = float(np.mean(bf16["mask"] == f32["mask"]))
    dprob = 0.0
    for c in range(2):
        a = read_image(os.path.join(bf16["out"], f"prob_{c}.mha")).data
        b = read_image(os.path.join(f32["out"], f"prob_{c}.mha")).data
        check(bool(np.isfinite(a).all() and np.isfinite(b).all()),
              "non-finite probabilities")
        dprob = max(dprob, float(np.abs(a - b).max()))
    fg = [r["mask"] == 1 for r in (bf16, f32)]
    dice = float(2 * np.sum(fg[0] & fg[1]) / max(1, np.sum(fg[0]) + np.sum(fg[1])))
    fg_body = float(np.mean(fg[1][body]))
    emit("bf16_vs_f32", agreement=agree, min_agreement=AGREE_MIN,
         foreground_dice=dice, min_dice=DICE_MIN,
         max_abs_dprob=dprob, max_dprob=DPROB_MAX,
         foreground_fraction_bf16=float(np.mean(fg[0])),
         foreground_fraction_f32=float(np.mean(fg[1])),
         foreground_fraction_of_body_f32=fg_body, body_fraction=float(np.mean(body)),
         f32_seconds=f32["wall"], f32_stages=f32["stages"], gpu=gpu)
    check(FG_BODY[0] <= fg_body <= FG_BODY[1],
          f"f32 foreground is {fg_body} of the body, outside {FG_BODY}")
    check(agree >= AGREE_MIN, f"bf16/f32 agreement {agree} < {AGREE_MIN}")
    check(dice >= DICE_MIN, f"bf16/f32 foreground Dice {dice} < {DICE_MIN}")
    check(dprob <= DPROB_MAX, f"bf16/f32 max |dprob| {dprob} > {DPROB_MAX}")
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "segmentation3d_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from segmentation3d_tpu_torch.ops import thin_conv as tc

    gpu = gpu_line()
    emit("device", gpu=gpu, torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    t = time.perf_counter()
    lib = tc.build_library()
    emit("build", seconds=time.perf_counter() - t, library=os.path.relpath(lib, HERE))

    sites = phase_kernels(torch, tc)
    with tempfile.TemporaryDirectory() as workdir:
        launches = phase_main(torch, tc, workdir, gpu)

    fwd = [r for r in sites if r["per_forward"]]

    def per_forward(key):
        return sum(r[key] * r["per_forward"] for r in fwd)

    t_bytes = sum(r["bytes"] * r["per_forward"] for r in fwd) / PEAK_BYTES * 1e3
    t_ops = sum(r["flops"] * r["per_forward"] for r in fwd) / PEAK_BF16_FLOPS * 1e3
    print(gpu)
    print(json.dumps({"kernels": [{
        "name": "thin_conv3d", "route": "cuda",
        "source": "segmentation3d_tpu_torch/csrc/thin_conv3d.cu",
        "replaces": "segmentation3d_tpu/ops/pallas_conv.py:174",
        "launches": launches,
        # the main path's bf16 sites; the epilogue variants' errors (int8
        # in steps) are on their own "kernel" lines
        "max_abs_err": max(r["max_abs_err"] for r in fwd),
        # one forward of a batch of 8 96^3 patches: its 20 launches summed
        "ms": per_forward("kernel_ms"), "plain_ms": per_forward("plain_ms"),
        "bound_ms": per_forward("bound_ms"),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": per_forward("library_ms")}]}))
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
