"""``seg_train`` on one GPU: one ``train()`` call from a config file.

Set-up makes the pool with its labels, writes the seeded initial weights as
the checkpoint ``chk_0`` that the config resumes from (so that the program
and the reference start from the same weights, made by the benchmark),
and runs a first ``train()`` call of ``warm_steps`` steps in a save dir of
its own: it loads the cases, tunes cuDNN and fills the allocator, and its
step time sizes the window. The window is a second ``train()`` call, from
``chk_0`` again, of as many steps as fill ``--seconds``; ``crops_per_s``
is its steps times the batch over its ``loop_seconds``. A traced run
profiles a call of ``trace_steps`` steps instead.

The window's first three steps are held against the plain float32
reference: ``train_step`` of the program is wrapped for them (and restored
after), to keep each step's crops, labels and loss, the first gradient as
Adam holds it after one step, and the weights after three. The reference
follows the three steps from ``chk_0`` on the same crops, as the program's
data stage made them (see ``PERF.md``).
"""
from __future__ import annotations

import os
import time

import torch

from portbench import cases, devtrace, flops, weights
from portbench.reference import nets, train_ref

CONFIG = """from easydict import EasyDict as edict
from segmentation3d.utils.normalizer import FixedNormalizer

__C = edict()
cfg = __C
__C.general = edict()
__C.general.imseg_list = r"{imseg}"
__C.general.save_dir = r"{save_dir}"
__C.general.resume_epoch = 0
__C.general.num_gpus = 1
__C.general.seed = {seed}
__C.dataset = edict()
__C.dataset.num_modality = 1
__C.dataset.num_classes = {classes}
__C.dataset.spacing = {spacing}
__C.dataset.crop_size = {crop}
__C.dataset.sampling_method = "{sampling}"
__C.dataset.random_translation = {translation}
__C.dataset.interpolation = "LINEAR"
__C.dataset.crop_normalizers = [FixedNormalizer(mean={mean}, stddev={stddev}, clip={clip})]
__C.loss = edict()
__C.loss.name = "Dice"
__C.loss.obj_weight = None
__C.net = edict()
__C.net.name = "{net}"
__C.net.base_channels = {base}
__C.net.down_convs = {down}
__C.net.up_convs = {up}
__C.train = edict()
__C.train.epochs = {epochs}
__C.train.batchsize = {batch}
__C.train.num_threads = 2
__C.train.lr = {lr}
__C.train.betas = ({b1}, {b2})
__C.train.save_epochs = {save_epochs}
__C.debug = edict()
__C.debug.save_inputs = False
__C.tpu = edict()
__C.tpu.dtype = "{dtype}"
__C.tpu.remat = {remat}
__C.tpu.mesh = edict()
__C.tpu.mesh.data = -1
__C.tpu.steps_per_dispatch = 1
"""


def write_config(ctx, path, save_dir, imseg, steps):
    cfg, tr, n, norm = ctx.cfg, ctx.traffic, ctx.cfg["net"], ctx.cfg["normalizer"]
    per_step = tr["batch_size"] / len(tr["pool"]["slices"])  # epochs per step
    epochs = int(round(steps * per_step))
    with open(path, "w") as f:
        f.write(CONFIG.format(
            imseg=imseg, save_dir=save_dir, seed=tr["sampler_seed"],
            classes=n["num_classes"], spacing=list(cfg["spacing_mm"]),
            crop=list(cfg["crop"][::-1]), sampling=tr["sampling"],
            translation=tr["random_translation"], mean=norm["mean"],
            stddev=norm["stddev"], clip=norm["clip"], net=n["name"],
            base=n["base_channels"], down=list(n["down_convs"]),
            up=list(n["up_convs"]), epochs=epochs, batch=tr["batch_size"],
            lr=tr["lr"], b1=tr["betas"][0], b2=tr["betas"][1],
            save_epochs=10 * epochs + 10, dtype=tr["dtype"], remat=tr["remat"]))


def initial_checkpoint(ctx, save_dir, net):
    """``chk_0`` of ``save_dir``: the seeded weights, resumed from at batch 0."""
    from segmentation3d_tpu_torch.utils.model_io import save_checkpoint
    from segmentation3d_tpu_torch.utils.normalizer import FixedNormalizer
    cfg, n, norm = ctx.cfg, ctx.cfg["net"], ctx.cfg["normalizer"]
    save_checkpoint(save_dir, 0, -1, net.state_dict(), n["name"], 2 ** len(n["down_convs"]),
                    n["in_channels"], n["num_classes"], cfg["spacing_mm"], "LINEAR",
                    [FixedNormalizer(norm["mean"], norm["stddev"], norm["clip"])],
                    extra={"net_kwargs": {k: n[k] for k in
                                          ("base_channels", "down_convs", "up_convs")}})


class Capture:
    """Wraps the program's ``train_step`` for the first ``steps`` calls."""

    def __init__(self, module, steps=3):
        self.module, self.steps = module, steps
        self.inner = module.train_step
        self.batches, self.losses, self.grad1, self.after = [], [], None, None
        self.t_first = None
        module.train_step = self

    def __call__(self, net, optimizer, loss_fn, images, segs, **kw):
        if self.t_first is None:
            self.t_first = time.perf_counter()
        self.batches.append((images.detach().clone(), segs.detach().clone()))
        loss = self.inner(net, optimizer, loss_fn, images, segs, **kw)
        self.losses.append(loss.detach().clone())
        params = dict(net.named_parameters())
        if len(self.batches) == 1:
            beta1 = optimizer.param_groups[0]["betas"][0]
            self.grad1 = {k: optimizer.state[p]["exp_avg"].detach() / (1 - beta1)
                          for k, p in params.items()}
        if len(self.batches) == self.steps:
            self.after = {k: p.detach().clone() for k, p in params.items()}
            self.module.train_step = self.inner
        return loss


def prepare(ctx):
    """The pool with its labels as files and the list naming them, and the
    seeded initial weights (a state dict on the device); kept on ``ctx``."""
    if getattr(ctx, "train_inputs", None) is None:
        dev = torch.device(ctx.device)
        pool = cases.make_pool(ctx.seed, ctx.traffic["pool"], dev)
        images, labels = cases.write_pool(pool, os.path.join(ctx.tmp, "pool"),
                                          with_labels=True)
        imseg = os.path.join(ctx.tmp, "train.txt")
        with open(imseg, "w") as f:
            f.write("\n".join([str(len(images))] +
                              [p for ab in zip(images, labels) for p in ab]) + "\n")
        net = weights.seeded(nets.build(ctx.cfg), ctx.seed, ctx.cfg, dev, calibrate=False)
        ctx.train_inputs = imseg, {k: v.detach().clone() for k, v in net.state_dict().items()}
    return ctx.train_inputs


def call(ctx, tag, steps, capture=False):
    """One ``train()`` call of ``steps`` steps from ``chk_0`` in a save dir
    of its own: ``(stats, Capture or None)``."""
    from segmentation3d_tpu_torch.core import seg_train
    imseg, start = prepare(ctx)
    save_dir = os.path.join(ctx.tmp, tag)
    net = nets.build(ctx.cfg)
    net.load_state_dict(start)
    initial_checkpoint(ctx, save_dir, net)
    path = os.path.join(ctx.tmp, f"{tag}.py")
    write_config(ctx, path, save_dir, imseg, steps)
    cap = Capture(seg_train) if capture else None
    stats = {}
    seg_train.train(path, device=torch.device(ctx.device), stats=stats)
    return stats, cap


def window_capture(ctx, steps, tag):
    """A captured call of ``steps`` steps: ``(Capture, initial state)``."""
    _, cap = call(ctx, tag, steps, capture=True)
    return cap, prepare(ctx)[1]


def run(ctx):
    tr, cfg = ctx.traffic, ctx.cfg
    dev = torch.device(ctx.device)
    _, start = prepare(ctx)
    warm, _ = call(ctx, "warm", tr["warm_steps"])
    step_s = warm["loop_seconds"] / warm["steps"]
    steps = tr["trace_steps"] if ctx.trace else max(8, int(round(ctx.seconds / step_s)))
    path = os.path.join(ctx.tmp, "trace.json")
    with devtrace.profiled(path, ctx.trace):
        stats, cap = call(ctx, "window", steps, capture=True)
    # set-up ends where the window call's loop takes its first batch
    setup_s = cap.t_first - ctx.t_start
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    trace = devtrace.reduce(path) if ctx.trace else None
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    gaps = train_ref.compare(cfg, tr, start, cap, dev)
    ref_s = time.perf_counter() - t
    batch = tr["batch_size"]
    done = stats.get("steps", 0)
    run = {
        "attempted": steps, "failed": steps - done, "memory_peak_bytes": peak,
        "e2e": {"crops_per_s": done * batch / stats["loop_seconds"], "setup_s": setup_s},
        "stats": stats, "steps": done, "trace": trace, "peak": flops.peaks(),
        "step_flops": 3.0 * batch * flops.forward_flops(cfg["net"], cfg["crop"]),
        "reference_s": ref_s,
    }
    lim = ctx.limits
    run["checks"] = [("failed", steps - done, 0)] + [
        (name, gaps[name], lim[name]) for name in lim["compared"]]
    run["diagnostics"] = dict(gaps, warm_step_s=step_s, steps=done, reference_s=ref_s,
                              losses=[float(x) for x in cap.losses])
    print(f"portbench: {run['diagnostics']}")
    run["correct"] = all(v <= limit for _, v, limit in run["checks"])
    return run
