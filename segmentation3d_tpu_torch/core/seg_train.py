"""Training loop, on one GPU or over several ranks.

The port of ``segmentation3d_tpu/core/seg_train.py:train(config_file)``, with
its observable behaviour: the save-dir lifecycle (a fresh run wipes the
save dir, or refuses when it holds files a run does not write), seeding of
the sampler and the crop stream, the net chosen by ``cfg.net.name`` and
``crop_size % max_stride == 0``, Adam or SGD with the cosine / linear / step
schedules as optax computes them, ``grad_accum_steps``, per-batch
``epoch/batch/train loss/time`` log lines and ``train_loss.csv``,
checkpoints every ``save_epochs`` epochs (and at the end) with the config
copy, ``net_kwargs`` and the optimizer state, ``keep_checkpoints``, resume
from ``resume_epoch``, ``val_list`` validation with ``val_dice.csv`` and
``save_best`` -> ``chk_best``, ``debug.save_inputs`` and the loss and val
curves.

One step: the net's forward in train mode (BatchNorm on the batch's
statistics), the loss in float32, ``backward``, one optimizer step. float32
runs with TF32 off; bfloat16 (``cfg.tpu.dtype``) runs the forward under
``torch.autocast``: bf16 convs, float32 parameters, BatchNorm, softmax and
loss, as the flax net with ``dtype=bf16``. Batch b+1 is cropped on the
device by a background thread on its own CUDA stream while step b runs
(:class:`_BatchPrefetcher`). Loss values are read back every ``log_every``
steps and at save points, never once per step. The loop's host work is
:mod:`..utils.tracing` spans: ``train.call`` (the root), ``train.batch_wait``,
``train.step`` (``train_step``'s enqueue), ``train.flush``,
``train.save_point``, and the prefetcher's ``train.batch``; the dataset
counts the crops whose case its device cache does not hold and the bytes
of the source boxes it uploaded for them (``train.stage_miss``,
``train.stage_bytes``). ``debug.profile_dir`` writes
the profiler's Chrome trace with these spans, from every thread, in it.

``cfg.tpu.conv_backend``, ``cfg.tpu.steps_per_dispatch`` and
``cfg.tpu.log_every`` choose how a TPU runs the same function: their values
and clash rules are checked as the JAX package checks them, then the same
sequence of single steps runs. As in the JAX package, a resumed run restores
the weights, the BatchNorm statistics and the optimizer (its step count
too) and starts the sampler and crop streams again from the seed.

Several GPUs (``cfg.tpu.mesh.data``, ``cfg.tpu.mesh.spatial``,
``cfg.general.num_gpus``; -1: every device) train as one process per GPU,
a rank of a ``torch.distributed`` group (:func:`train_ranks`: torchrun's
group, or one rank spawned per GPU). The ranks form the JAX package's
``(data, spatial)`` mesh (``parallel/train_mesh.py``): each crops its rows
of every batch from the shared index stream, and its z planes; the net is
wrapped in ``DistributedDataParallel``; BatchNorm normalizes over the
whole (micro)batch and every z slab, each 3^3 conv exchanges a halo plane
with its z neighbours, Dice sums over the z slabs
(``parallel/collectives.py``), so the step is the JAX package's mesh step:
the global batch's mean gradient. Rank 0 alone writes the save dir (from
the unwrapped net, so the checkpoint is the one-GPU one) and validates;
the others wait at a barrier. With one rank no collective is issued.
"""
from __future__ import annotations

import contextlib
import math
import os
import queue
import shutil
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from segmentation3d_tpu_torch.config import load_config
from segmentation3d_tpu_torch.dataloader import EpochConcateSampler, SegmentationDataset
from segmentation3d_tpu_torch.losses import create_loss
from segmentation3d_tpu_torch.models import get_network_module, trainable
from segmentation3d_tpu_torch.models.vnet import (distribute_, init_like_flax_,
                                                  vnet_focal_init)
from segmentation3d_tpu_torch.parallel import distributed
from segmentation3d_tpu_torch.parallel.collectives import world_mean
from segmentation3d_tpu_torch.parallel.train_mesh import (TrainMesh, mesh_shape,
                                                          requested_devices)
from segmentation3d_tpu_torch.utils import model_io, tracing
from segmentation3d_tpu_torch.utils.device import no_tf32, resolve_device
from segmentation3d_tpu_torch.utils.file_io import setup_logger

#: what a training run itself writes into its save dir: a fresh run over a
#: completed one wipes these and refuses to wipe anything else
RUN_FILES = {"checkpoints", "train_log.txt", "train_loss.csv", "debug",
             "train_loss.png", "val_dice.csv", "val_dice.png"}


def _check_trainable(cfg):
    """Refuse a net whose module says it cannot be trained here."""
    name = (cfg.get("net") or {}).get("name")
    if name is not None and not trainable(name):
        raise NotImplementedError(
            f"training {name!r} is not supported yet: the port runs it "
            "for inference only (seg_infer, seg_serve)")


def _prepare_save_dir(save_dir: str, resume: bool):
    """A fresh (non-resume) run wipes the save dir, unless it holds entries
    a training run does not write."""
    if os.path.isdir(save_dir) and not resume:
        entries = set(os.listdir(save_dir))
        if entries and not entries <= RUN_FILES:
            raise RuntimeError(
                f"refusing to wipe {save_dir}: contains non-checkpoint entries "
                f"{sorted(entries - RUN_FILES)}; remove it manually or resume")
        shutil.rmtree(save_dir)
    os.makedirs(save_dir, exist_ok=True)


class _BatchPrefetcher:
    """Assembles upcoming batches on a background thread: batch b+1 is
    cropped and normalized on the device while step b runs. On a CUDA
    device the thread works on a stream of its own and records an event
    after each batch; the consumer's stream waits for it, and the batch's
    tensors are marked as used by that stream (``record_stream``), so the
    allocator does not hand their memory to the next batch early. A failing
    batch raises in the train loop (``RuntimeError``), never hangs it.
    Each batch is a ``train.batch`` span of the thread; ``wait_seconds``
    sums the time the consumer waited for a batch (its ``train.batch_wait``
    spans).

    Over several ranks every rank draws the same global index stream and
    crops only its own positions of each batch (``rows``) and keeps its own
    planes of each crop (``z``); frames and names are those of its rows."""

    def __init__(self, dataset, index_iter, batchsize, device, depth=2,
                 rows=None, z=None):
        self.dataset = dataset
        self.index_iter = index_iter
        self.batchsize = batchsize
        self.rows, self.z = rows, z
        self.device = torch.device(device)
        self.wait_seconds = 0.0
        self._stop = threading.Event()
        self.q = queue.Queue(maxsize=max(1, depth))
        self._within = tracing.context()
        self.thread = threading.Thread(target=self._run, name="batch-prefetch",
                                       daemon=True)
        self.thread.start()

    def _run(self):
        cuda = self.device.type == "cuda"
        stream = torch.cuda.Stream(self.device) if cuda else None
        with torch.cuda.stream(stream):
            while not self._stop.is_set():
                try:
                    idxs = [next(self.index_iter) for _ in range(self.batchsize)]
                except StopIteration:
                    self.q.put(None)
                    return
                if self.rows is not None:
                    idxs = [idxs[i] for i in self.rows]
                try:
                    with tracing.span("train.batch", within=self._within):
                        images, segs, frames, names = self.dataset.batch(idxs)
                    if self.z is not None:
                        images = images[:, self.z].contiguous()
                        segs = segs[:, self.z].contiguous()
                    ready = stream.record_event() if cuda else None
                except Exception as e:  # surfaced in the train loop
                    self.q.put(e)
                    return
                self.q.put((images, segs, frames, names, ready))

    def stop(self):
        """Stop assembling and let the thread end."""
        self._stop.set()
        while self.thread.is_alive():
            try:
                self.q.get(timeout=0.05)
            except queue.Empty:
                pass

    def __iter__(self):
        return self

    def __next__(self):
        with tracing.span("train.batch_wait") as wait:
            item = self.q.get()
        self.wait_seconds += wait.seconds
        if item is None:
            raise StopIteration
        if isinstance(item, Exception):
            raise RuntimeError(f"batch assembly failed: {item}") from item
        images, segs, frames, names, ready = item
        if ready is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(ready)
            images.record_stream(current)
            segs.record_stream(current)
        return images, segs, frames, names


# ---------------------------------------------------------------------------
# learning rate per step, as optax computes it (the first step is count 0)
# ---------------------------------------------------------------------------

def cosine_decay_schedule(init_value, decay_steps, alpha=0.0):
    """``optax.cosine_decay_schedule(init_value, decay_steps, alpha)``."""
    def lr(count):
        c = min(count, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
        return init_value * ((1.0 - alpha) * cosine + alpha)
    return lr


def linear_schedule(init_value, end_value, transition_steps):
    """``optax.linear_schedule(init_value, end_value, transition_steps)``."""
    def lr(count):
        if transition_steps <= 0:
            return init_value
        c = min(max(count, 0), transition_steps)
        return (init_value - end_value) * (1.0 - c / transition_steps) + end_value
    return lr


def exponential_decay(init_value, transition_steps, decay_rate):
    """``optax.exponential_decay(..., staircase=True)``."""
    def lr(count):
        if transition_steps <= 0:
            return init_value
        return init_value * decay_rate ** math.floor(count / transition_steps)
    return lr


def make_schedule(cfg_train, dataset_len, epochs, batchsize):
    """``count -> learning rate`` for ``cfg.train`` (constant without an
    ``lr_scheduler``)."""
    lr = float(cfg_train.lr)
    sched_cfg = cfg_train.get("lr_scheduler", None)
    if not sched_cfg:
        return lambda count: lr
    total_steps = max(1, (dataset_len * epochs) // batchsize)
    kind = str(sched_cfg.get("name", "cosine")).lower()
    if kind == "cosine":
        return cosine_decay_schedule(lr, total_steps,
                                     float(sched_cfg.get("alpha", 0.0)))
    if kind == "linear":
        return linear_schedule(lr, float(sched_cfg.get("end_lr", 0.0)),
                               total_steps)
    if kind == "step":
        every = int(sched_cfg.get("step_epochs", 10))
        steps_per_epoch = max(1, dataset_len // batchsize)
        return exponential_decay(lr, every * steps_per_epoch,
                                 float(sched_cfg.get("gamma", 0.1)))
    raise ValueError(f"unknown lr_scheduler {kind}")


def make_optimizer(cfg_train, params):
    """``cfg.train.optimizer``: 'adam' (betas, eps 1e-8, as ``optax.adam``)
    or 'sgd' (with ``momentum`` when given, as ``optax.sgd``)."""
    opt_name = str(cfg_train.get("optimizer", "adam")).lower()
    lr = float(cfg_train.lr)
    if opt_name == "adam":
        return torch.optim.Adam(params, lr=lr, eps=1e-8,
                                betas=(float(cfg_train.betas[0]),
                                       float(cfg_train.betas[1])))
    if opt_name == "sgd":
        return torch.optim.SGD(params, lr=lr,
                               momentum=float(cfg_train.get("momentum", 0) or 0))
    raise ValueError(f"unknown cfg.train.optimizer {opt_name!r} "
                     "(supported: 'adam', 'sgd')")


def train_step(net, optimizer, loss_fn, images, segs, *, dtype=torch.float32,
               accum=1, lr=None):
    """One optimizer step of ``net`` (train mode) on the batch ``images [B,
    D,H,W,C]``, ``segs [B,D,H,W]``: ``accum`` microbatches of ``B // accum``
    rows, each normalized by its own BatchNorm statistics (the running ones
    move once per microbatch), the mean of their gradients, one update at
    ``lr`` (when given). Returns the mean loss as a device scalar: nothing
    is read back. ``net`` may be a ``DistributedDataParallel``: its
    gradients are then averaged over the ranks once, after the last
    microbatch (the others run under ``no_sync``)."""
    b = images.shape[0]
    if b % accum:
        raise ValueError(f"batch {b} must divide by grad_accum_steps {accum}")
    mb = b // accum
    dev_type = images.device.type
    net.train()
    optimizer.zero_grad(set_to_none=True)
    total = None
    with no_tf32():
        for i in range(accum):
            x, y = images[i * mb:(i + 1) * mb], segs[i * mb:(i + 1) * mb]
            defer = i + 1 < accum and hasattr(net, "no_sync")
            with net.no_sync() if defer else contextlib.nullcontext():
                with torch.autocast(dev_type, dtype=torch.bfloat16,
                                    enabled=dtype == torch.bfloat16):
                    probs = net(x)
                loss = loss_fn(probs.to(torch.promote_types(probs.dtype,
                                                            torch.float32)), y)
                (loss / accum).backward()
            total = loss.detach() if total is None else total + loss.detach()
        if lr is not None:
            for group in optimizer.param_groups:
                group["lr"] = lr
        optimizer.step()
    return total / accum


def _check_execution_knobs(cfg, crop_size, grad_accum, batchsize, max_stride,
                           world=1, rank=0, hosts=1):
    """The JAX package's ``cfg.tpu`` / mesh rules, in its order, for a group
    of ``world`` ranks (one device each) on ``hosts`` nodes: returns
    ``(conv_backend, steps_per_dispatch, log_every, mesh)``."""
    tpu = cfg.get("tpu", {})
    conv_backend = str(tpu.get("conv_backend", "direct"))
    if conv_backend not in ("direct", "window", "packed_domain"):
        raise ValueError(
            f"cfg.tpu.conv_backend {conv_backend!r} is not one of "
            "'direct', 'window', 'packed_domain'")
    if conv_backend == "packed_domain":
        # the JAX package's in_block packing: the largest power of 2 P with
        # P * base_channels <= 128 must divide the crop width
        base, p0 = int(cfg.net.get("base_channels", 16)), 1
        while 2 * p0 * base <= 128:
            p0 *= 2
        if int(crop_size[0]) % p0 != 0:
            raise ValueError(
                f"conv_backend 'packed_domain' requires crop width "
                f"(crop_size x = {int(crop_size[0])}) % {p0} == 0 (the "
                f"in_block packing); use 'window' otherwise")
    mesh = TrainMesh.from_config(cfg, world, rank)
    mesh.check(batchsize=batchsize, crop_z=int(crop_size[2]),
               max_stride=max_stride, grad_accum=grad_accum,
               conv_backend=conv_backend, hosts=hosts)
    if mesh.size != world:
        raise ValueError(
            f"the config's mesh ({mesh.data} x {mesh.spatial}) uses "
            f"{mesh.size} of the group's {world} ranks; start {mesh.size} "
            "ranks, or set cfg.tpu.mesh.data to -1")
    steps_per_dispatch = max(1, int(tpu.get("steps_per_dispatch", 1)))
    if cfg.debug.get("save_inputs", False):
        steps_per_dispatch = 1  # as in the JAX package: forced before the clash check
    if steps_per_dispatch > 1 and grad_accum > 1:
        raise ValueError("cfg.tpu.steps_per_dispatch > 1 and "
                         "cfg.train.grad_accum_steps > 1 cannot be combined")
    log_every = max(1, int(tpu.get("log_every", 8)))
    return conv_backend, steps_per_dispatch, log_every, mesh


def _save_inputs(save_dir, batch_idx, images, segs, frames, names):
    from segmentation3d_tpu_torch.io import Volume, write_image
    dbg = os.path.join(save_dir, "debug")
    for b, (frame, name) in enumerate(zip(frames, names)):
        img_np = images[b].detach().to("cpu", torch.float32).numpy()
        for c in range(img_np.shape[-1]):
            write_image(Volume(img_np[..., c], frame),
                        os.path.join(dbg, f"batch{batch_idx}_{name}_mod{c}.nii.gz"))
        write_image(Volume(segs[b].cpu().numpy().astype(np.uint8), frame),
                    os.path.join(dbg, f"batch{batch_idx}_{name}_seg.nii.gz"))


@tracing.traced("train.call")
def train(config_file: str, gpu_id: int = 0, device=None, stats: dict | None = None):
    """Train the config's net on ``cuda:<gpu_id>`` (``device``/``gpu_id=-1``:
    the CPU); raises when no CUDA device is available and the CPU was not
    asked for. In an initialized ``torch.distributed`` group this process
    is one rank of the config's mesh, which must use every rank of the
    group (:func:`train_ranks` starts the group); otherwise the mesh is
    one device, as ``make_mesh`` clamps a request for more. Returns the
    save dir. ``stats``: a dict to fill with this rank's
    loop's timings: ``steps``, ``loop_seconds`` (the step loop, its save
    points included, the final one not), ``prefetch_wait_seconds`` (of the
    loop waiting for a batch), ``flushes`` (``(steps, perf_counter,
    prefetch_wait_seconds)`` at each loss readback, which waits for the
    device), and per save point ``save_point_seconds`` (checkpoint +
    validation) and ``validation_seconds``."""
    cfg = load_config(config_file)
    _check_trainable(cfg)
    dev = resolve_device(device, gpu_id)
    stats = {} if stats is None else stats
    world, rank = distributed.process_count(), distributed.process_index()
    primary = rank == 0

    save_dir = cfg.general.save_dir
    resume_epoch = int(cfg.general.resume_epoch)
    resume = resume_epoch >= 0
    if primary:  # one rank owns the save dir and every file in it
        _prepare_save_dir(save_dir, resume)
    distributed.barrier("save_dir_ready")
    logger = setup_logger(os.path.join(save_dir, "train_log.txt"), to_file=primary)
    if world > 1:
        devices = [None] * world
        dist.all_gather_object(devices, str(dev))
        logger.info(f"training group: backend {dist.get_backend()}, world "
                    f"{world}, devices by rank {devices}")

    seed = int(cfg.general.seed)
    np.random.seed(seed)

    dataset = SegmentationDataset(
        imseg_list=cfg.general.imseg_list,
        num_classes=cfg.dataset.num_classes,
        spacing=cfg.dataset.spacing,
        crop_size=cfg.dataset.crop_size,
        sampling_method=cfg.dataset.sampling_method,
        random_translation=cfg.dataset.random_translation,
        interpolation=cfg.dataset.interpolation,
        crop_normalizers=cfg.dataset.crop_normalizers,
        random_flip=bool(cfg.dataset.get("random_flip", False)),
        random_rot90=bool(cfg.dataset.get("random_rot90", False)),
        random_intensity_scale=cfg.dataset.get("random_intensity_scale", None),
        random_intensity_shift=cfg.dataset.get("random_intensity_shift", None),
        random_noise_std=float(cfg.dataset.get("random_noise_std", 0.0)),
        random_elastic_magnitude=float(
            cfg.dataset.get("random_elastic_magnitude", 0.0)),
        random_elastic_grid=int(cfg.dataset.get("random_elastic_grid", 4)),
        random_elastic_prob=float(cfg.dataset.get("random_elastic_prob", 1.0)),
        seed=seed, device=dev,
    )
    batchsize = int(cfg.train.batchsize)
    epochs = int(cfg.train.epochs)
    sampler = EpochConcateSampler(len(dataset), epochs, seed=seed)

    net_mod = get_network_module(cfg.net.name)
    max_stride = net_mod.max_stride()
    crop_size = np.asarray(cfg.dataset.crop_size, np.int64)
    if not np.all(crop_size % max_stride == 0):
        raise ValueError(f"crop_size {crop_size.tolist()} must be divisible "
                         f"by max_stride {max_stride}")
    dtype = torch.bfloat16 if cfg.get("tpu", {}).get("dtype", "float32") \
        == "bfloat16" else torch.float32
    grad_accum = max(1, int(cfg.train.get("grad_accum_steps", 1)))
    # JAX's processes are hosts: the nodes of torchrun's group
    hosts = max(1, world // int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    _, steps_per_dispatch, log_every, mesh = _check_execution_knobs(
        cfg, crop_size, grad_accum, batchsize, max_stride, world, rank, hosts)

    # optional architecture hyper-params (recorded in checkpoints so
    # inference rebuilds the same net)
    net_kwargs = {k: cfg.net[k] for k in
                  ("base_channels", "act", "bottleneck", "down_convs", "up_convs")
                  if k in cfg.net}
    net = net_mod.SegmentationNet(
        in_channels=dataset.num_modality,
        out_channels=int(cfg.dataset.num_classes),
        remat=bool(cfg.get("tpu", {}).get("remat", True)), **net_kwargs)
    init_like_flax_(net, torch.Generator().manual_seed(seed))
    if cfg.loss.name == "Focal":
        vnet_focal_init(net, obj_p=0.01)
    net.to(dev)
    optimizer = make_optimizer(cfg.train, net.parameters())
    schedule = make_schedule(cfg.train, len(dataset), epochs, batchsize)
    opt_count = 0

    start_batch_idx = 0
    if resume:
        chk = model_io.checkpoint_dir(save_dir, resume_epoch)
        payload = model_io.load_checkpoint(chk, net)
        saved_opt = model_io.load_opt_state(chk)
        if saved_opt is not None:
            optimizer.load_state_dict(saved_opt["optimizer"])
            opt_count = int(saved_opt["step"])
        start_batch_idx = int(payload.get("batch_idx", 0)) + 1
        logger.info(f"resumed from {chk} (epoch {resume_epoch})")

    model, z_group = net, None
    if world > 1:
        from torch.nn.parallel import DistributedDataParallel
        z_group = mesh.spatial_group()
        distribute_(net, dist.group.WORLD, z_group)
        # the synced BatchNorm statistics are equal on every rank already
        model = DistributedDataParallel(
            net, device_ids=[dev.index] if dev.type == "cuda" else None,
            broadcast_buffers=False)
    loss_fn = create_loss(cfg.loss, int(cfg.dataset.num_classes), z_group=z_group)
    if steps_per_dispatch > 1:
        logger.info(f"cfg.tpu.steps_per_dispatch = {steps_per_dispatch}: "
                    "runs as single steps on the GPU")

    loss_csv = os.path.join(save_dir, "train_loss.csv")
    if primary and not os.path.isfile(loss_csv):
        with open(loss_csv, "w") as f:
            f.write("epoch,batch,loss\n")
    num_classes = int(cfg.dataset.num_classes)
    extra_kw = {"net_kwargs": dict(net_kwargs)} if net_kwargs else {}

    def write_checkpoint(epoch_idx, batch_idx, **kw):
        return model_io.save_checkpoint(
            save_dir, epoch_idx, batch_idx, net.state_dict(),
            cfg.net.name, max_stride, dataset.num_modality, num_classes,
            cfg.dataset.spacing, cfg.dataset.interpolation,
            cfg.dataset.crop_normalizers, config_file=config_file, **kw)

    def save(epoch_idx, batch_idx):
        write_checkpoint(epoch_idx, batch_idx, extra=extra_kw or None,
                         opt_state={"optimizer": optimizer.state_dict(),
                                    "step": opt_count})
        logger.info(f"saved checkpoint chk_{epoch_idx}")
        for d in model_io.prune_checkpoints(
                save_dir, int(cfg.train.get("keep_checkpoints", 0))):
            logger.info(f"pruned old checkpoint {os.path.basename(d)}")

    val_list = cfg.train.get("val_list", None)
    val_csv = os.path.join(save_dir, "val_dice.csv")
    val_cache = {}  # the device case cache, run-lifetime
    save_best = bool(cfg.train.get("save_best", False))
    if save_best and not val_list:
        raise ValueError("cfg.train.save_best requires cfg.train.val_list")
    best_dice = -1.0
    if save_best and resume:
        best_chk = os.path.join(save_dir, "checkpoints", "chk_best")
        if os.path.isfile(os.path.join(best_chk, "params.pth")):
            prev = model_io.load_checkpoint_payload(best_chk)
            best_dice = float(prev.get("val_dice", -1.0))
    stats.setdefault("validation_seconds", [])
    stats.setdefault("save_point_seconds", [])

    def save_point(epoch_idx, batch_idx):
        with tracing.span("train.save_point") as span:
            if primary:
                save(epoch_idx, batch_idx)
                validate(epoch_idx, batch_idx)
            distributed.barrier(f"chk_{epoch_idx}")
        stats["save_point_seconds"].append(span.seconds)

    def validate(epoch_idx, batch_idx):
        nonlocal best_dice
        if not val_list:
            return
        from segmentation3d_tpu_torch.core.validation import validate_cases
        t = time.perf_counter()
        mean_dice, per_class, n = validate_cases(
            net, val_list,
            spacing=cfg.dataset.spacing,
            interpolation=cfg.dataset.interpolation,
            normalizers=cfg.dataset.crop_normalizers,
            num_classes=num_classes, max_stride=max_stride,
            shape_bucket=int(cfg.train.get("val_shape_bucket", 32)),
            size_cap=int(cfg.train.get("val_size_cap", 256)),
            slab_z=int(cfg.train.get("val_slab_z", 64)),
            dtype=dtype, inferer_cache=val_cache,
            case_cache_gb=float(cfg.train.get("val_cache_gb", 2.0)))
        stats["validation_seconds"].append(time.perf_counter() - t)
        detail = ", ".join(f"c{c + 1}: {d:.4f}" for c, d in enumerate(per_class))
        logger.info(f"epoch: {epoch_idx}, val dice: {mean_dice:.4f} "
                    f"({n} cases{'; ' + detail if len(per_class) > 1 else ''})")
        header = not os.path.isfile(val_csv)
        with open(val_csv, "a") as f:
            if header:
                cols = ",".join(f"dice_c{c + 1}" for c in range(len(per_class)))
                f.write(f"epoch,val_dice{',' + cols if cols else ''}\n")
            vals = ",".join(f"{d}" for d in per_class)
            f.write(f"{epoch_idx},{mean_dice}{',' + vals if vals else ''}\n")
        if save_best and mean_dice > best_dice:
            best_dice = mean_dice
            write_checkpoint(epoch_idx, batch_idx, dir_name="chk_best",
                             extra={"val_dice": float(mean_dice), **extra_kw})
            logger.info(f"saved chk_best (val dice {mean_dice:.4f}, "
                        f"epoch {epoch_idx})")

    save_epochs = int(cfg.train.save_epochs)
    dataset_len = len(dataset)
    last_saved_epoch = resume_epoch if resume else -1
    prev_epoch = (start_batch_idx * batchsize) // dataset_len if resume else 0
    batch_idx = start_batch_idx
    total_batches = (dataset_len * epochs) // batchsize
    logger.info(f"training: {dataset_len} cases, {epochs} epochs, batch {batchsize}, "
                f"{mesh.size} device(s) (data {mesh.data} x spatial "
                f"{mesh.spatial}), rank {rank} on {dev}, net {cfg.net.name}, "
                f"loss {cfg.loss.name}")

    # loss values stay on the device until a flush: (epoch, batch, loss, s)
    pending = []
    stats["flushes"] = []

    def flush_logs():
        if not pending:
            return
        # every rank reads the losses (the global batch's: the mean over the
        # ranks), which keeps the ranks in step; rank 0 writes them
        with tracing.span("train.flush"):
            values = world_mean(torch.stack([p[2] for p in pending])).cpu().tolist()
        stats["flushes"].append((steps, time.perf_counter(),
                                 prefetcher.wait_seconds))
        if not primary:
            pending.clear()
            return
        with open(loss_csv, "a") as f:
            for (ep, bi, _, dt), lv in zip(pending, values):
                logger.info(f"epoch: {ep}, batch: {bi}, "
                            f"train loss: {lv:.4f}, time: {dt:.4f} s")
                f.write(f"{ep},{bi},{lv}\n")
        pending.clear()

    debug_ctx = contextlib.ExitStack()
    if cfg.debug.get("debug_nans", False):
        debug_ctx.enter_context(torch.autograd.detect_anomaly())
    profile_dir = cfg.debug.get("profile_dir", None) if primary else None
    profiler = None
    if profile_dir:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = debug_ctx.enter_context(torch.profiler.profile(activities=activities))

    prefetcher = _BatchPrefetcher(
        dataset, iter(sampler), batchsize, dev,
        depth=max(1, int(cfg.train.get("num_threads", 1))),
        rows=mesh.local_rows(batchsize, grad_accum) if mesh.data > 1 else None,
        z=mesh.local_z(int(crop_size[2])) if mesh.spatial > 1 else None)
    steps, t_loop = 0, time.perf_counter()
    with debug_ctx:
        try:
            while batch_idx < total_batches:
                t0 = time.time()
                try:
                    images, segs, frames, names = next(prefetcher)
                except StopIteration:
                    break
                with tracing.span("train.step"):
                    loss = train_step(model, optimizer, loss_fn, images, segs,
                                      dtype=dtype, accum=grad_accum,
                                      lr=schedule(opt_count))
                opt_count += 1
                steps += 1
                dt = time.time() - t0

                epoch_idx = (batch_idx * batchsize) // dataset_len
                pending.append((epoch_idx, batch_idx, loss, dt))
                if len(pending) >= log_every:
                    flush_logs()
                if cfg.debug.get("save_inputs", False) and world == 1:
                    # a single-process feature, as in the JAX package
                    _save_inputs(save_dir, batch_idx, images, segs, frames, names)
                if epoch_idx != prev_epoch and epoch_idx % save_epochs == 0 \
                        and epoch_idx != last_saved_epoch:
                    flush_logs()  # csv/logs complete up to every checkpoint
                    save_point(epoch_idx, batch_idx)
                    last_saved_epoch = epoch_idx
                prev_epoch = epoch_idx
                batch_idx += 1
        finally:
            prefetcher.stop()
        flush_logs()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stats.update(steps=steps, loop_seconds=time.perf_counter() - t_loop,
                     prefetch_wait_seconds=prefetcher.wait_seconds)
        final_epoch = (batch_idx * batchsize) // dataset_len
        if final_epoch != last_saved_epoch:
            save_point(final_epoch, max(batch_idx - 1, 0))
    if profiler is not None:
        os.makedirs(profile_dir, exist_ok=True)
        trace = os.path.join(profile_dir, "trace.json")
        profiler.export_chrome_trace(trace)
        tracing.add_to_chrome_trace(trace, tracing.take())
    if primary:
        from segmentation3d_tpu_torch.utils.plotting import (plot_loss_curve,
                                                             plot_val_curve)
        plot_loss_curve(loss_csv)
        plot_val_curve(val_csv)
    logger.info("training finished")
    return save_dir


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def spawn_count(config_file: str, gpu_id: int = 0) -> int:
    """How many ranks one ``seg_train`` process starts on this node: the
    config's mesh over the GPUs from ``cuda:<gpu_id>`` on, clamped as
    ``make_mesh`` clamps (JAX's errors for a mesh that does not fit); 1 on
    the CPU, which counts as one device, or without a CUDA device (the
    trainer then raises)."""
    if gpu_id < 0 or not torch.cuda.is_available():
        return 1
    devices, spatial = requested_devices(load_config(config_file))
    data, spatial = mesh_shape(devices, max(1, torch.cuda.device_count() - gpu_id),
                               spatial)
    return data * spatial


def _spawned_rank(index, config_file, gpu_id, world, port):
    os.environ.update(RANK=str(index), LOCAL_RANK=str(index), WORLD_SIZE=str(world),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    train_ranks(config_file, gpu_id)


def train_ranks(config_file: str, gpu_id: int = 0, stats: dict | None = None):
    """``seg_train``'s start. Under torchrun's environment (``WORLD_SIZE`` >
    1) this process joins its training group (the backend rule of
    :func:`..parallel.distributed.join_training`; ``gpu_id``: the first
    GPU), trains as its rank and leaves the group. Otherwise, when the
    config's mesh asks for more than one GPU and the node has them, one
    rank per GPU is spawned (``127.0.0.1``, a free port), as the JAX
    package's one process trains on every device. Otherwise :func:`train`
    runs in this process on one device. Returns the save dir."""
    if distributed.launcher_counts()["world"] > 1 and not dist.is_initialized():
        device = distributed.join_training(gpu_id)
        try:
            return train(config_file, device=device, stats=stats)
        finally:
            distributed.shutdown()
    _check_trainable(load_config(config_file))
    n = spawn_count(config_file, gpu_id)
    if n > 1:
        import torch.multiprocessing as mp
        mp.start_processes(_spawned_rank, nprocs=n, start_method="spawn",
                           args=(config_file, gpu_id, n, _free_port()))
        return load_config(config_file).general.save_dir
    return train(config_file, gpu_id=gpu_id, stats=stats)
