"""Training-config template — copy, edit, and pass to ``seg_train -i``.

The JAX package's template (``segmentation3d_tpu/config/template_config.py``)
field for field: one config file trains with either package. Fields marked
[TPU] are the JAX package's additions; in the port ``tpu.dtype``,
``tpu.remat`` and ``tpu.mesh`` act as there (the mesh's devices are GPUs,
one rank each), ``tpu.steps_per_dispatch`` and ``tpu.conv_backend`` are
checked and then run as single steps (``core/seg_train.py``).
"""
from easydict import EasyDict as edict
from segmentation3d.utils.normalizer import FixedNormalizer, AdaptiveNormalizer  # noqa: F401

__C = edict()
cfg = __C

# ---- general ---------------------------------------------------------------
__C.general = edict()
__C.general.imseg_list = "/path/to/train.txt"   # or .csv
__C.general.save_dir = "/path/to/model_dir"
__C.general.resume_epoch = -1                   # -1 = fresh run
__C.general.num_gpus = 1                        # data-parallel GPUs when
                                                # tpu.mesh.data is unset or 0
__C.general.seed = 0

# ---- dataset ---------------------------------------------------------------
__C.dataset = edict()
__C.dataset.num_modality = 1
__C.dataset.num_classes = 2
__C.dataset.spacing = [1.0, 1.0, 1.0]           # mm, fixed world spacing
__C.dataset.crop_size = [96, 96, 96]            # voxels, divisible by 16
__C.dataset.sampling_method = "MASK"            # GLOBAL | MASK | CENTER | MIX
__C.dataset.random_translation = [5.0, 5.0, 5.0]  # mm jitter
__C.dataset.interpolation = "LINEAR"            # image interp (seg uses NN)
__C.dataset.crop_normalizers = [FixedNormalizer(mean=-400.0, stddev=600.0, clip=True)]
# __C.dataset.random_flip = True                # [TPU] axis-flip augmentation
# __C.dataset.device_cache_gb = 2.0             # [TPU] device cache for volumes

# ---- loss ------------------------------------------------------------------
__C.loss = edict()
__C.loss.name = "Dice"                          # Dice | Focal
__C.loss.obj_weight = None                      # per-class weights
__C.loss.focal_obj_alpha = 0.25
__C.loss.focal_gamma = 2.0

# ---- net -------------------------------------------------------------------
__C.net = edict()
__C.net.name = "vnet"
# __C.net.base_channels = 16
# __C.net.act = "relu"                          # relu | prelu | leaky_relu
# __C.net.bottleneck = False

# ---- train -----------------------------------------------------------------
__C.train = edict()
__C.train.epochs = 1000
__C.train.batchsize = 8
__C.train.num_threads = 2                       # prefetch queue depth
__C.train.lr = 1e-4
__C.train.betas = (0.9, 0.999)
__C.train.save_epochs = 100
# __C.train.keep_checkpoints = 0                # [TPU] N>0 keeps only the
#                                               # newest N numeric chk dirs
#                                               # (chk_best never pruned)
# __C.train.grad_accum_steps = 1                # [TPU] A>1 splits each batch
#                                               # into A microbatches: mean-
#                                               # gradient equivalent at 1/A
#                                               # the activation memory (BN
#                                               # normalizes per microbatch)

# ---- debug -----------------------------------------------------------------
__C.debug = edict()
__C.debug.save_inputs = False                   # dump training crops as NIfTI
# __C.debug.profile_dir = "/tmp/trace"          # [TPU] profiler trace (the
#                                               # port: torch.profiler's
#                                               # trace.json, with the
#                                               # program's spans of every
#                                               # thread, each named, on
#                                               # its clock)
# __C.debug.debug_nans = False                  # [TPU] NaN checks (the port:
#                                               # autograd anomaly mode)

# ---- tpu [TPU] -------------------------------------------------------------
__C.tpu = edict()
__C.tpu.dtype = "float32"                       # float32 | bfloat16
__C.tpu.remat = True                            # checkpoint blocks (memory)
__C.tpu.mesh = edict()
__C.tpu.mesh.data = -1                          # data-parallel devices,
                                                # -1 = all devices (every
                                                # GPU from -g on; the CPU
                                                # is one); wins over
                                                # general.num_gpus
# __C.tpu.mesh.spatial = 1                      # [TPU] S>1 also shards each
#                                               # crop's z over S devices
#                                               # (crop z % (S * 16) == 0)
__C.tpu.steps_per_dispatch = 1                  # K>1 fuses K train steps
                                                # into one program on a
                                                # TPU; the port checks it
                                                # and runs single steps
