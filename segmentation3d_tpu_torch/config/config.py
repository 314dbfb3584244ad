"""Config system: python-file configs with EasyDict attribute access.

The port's copy of ``segmentation3d_tpu/config/config.py``. A config **is a
Python file** defining ``cfg`` as an ``EasyDict`` with sections ``general /
dataset / loss / net / train / debug`` (and ``tpu``, the JAX package's
execution section, whose keys the port checks and maps onto one GPU: see
``core/seg_train.py``). Configs written for the JAX package or for the
original PyTorch toolkit run unmodified: :func:`..utils.file_io.load_config`
aliases ``easydict`` and ``segmentation3d.*`` while it executes one.
"""
from __future__ import annotations


class EasyDict(dict):
    """dict with attribute access, recursively converting nested dicts —
    API-compatible with the ``easydict`` package."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        if d:
            for k, v in dict(d).items():
                self[k] = v
        for k, v in kwargs.items():
            self[k] = v

    def __setattr__(self, name, value):
        self[name] = value

    def __setitem__(self, name, value):
        if isinstance(value, dict) and not isinstance(value, EasyDict):
            value = EasyDict(value)
        elif isinstance(value, (list, tuple)):
            value = type(value)(EasyDict(v) if isinstance(v, dict)
                                and not isinstance(v, EasyDict) else v for v in value)
        super().__setitem__(name, value)

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __delattr__(self, name):
        del self[name]


def default_config() -> EasyDict:
    """The JAX package's template field set, with its defaults."""
    from segmentation3d_tpu_torch.utils.normalizer import FixedNormalizer

    c = EasyDict()

    c.general = EasyDict()
    c.general.imseg_list = ""          # training case list (.txt or .csv)
    c.general.save_dir = ""            # checkpoints/logs output dir
    c.general.resume_epoch = -1        # -1 = fresh run (wipes save_dir)
    c.general.num_gpus = 1             # only 1 is ported
    c.general.seed = 0

    c.dataset = EasyDict()
    c.dataset.num_modality = 1
    c.dataset.num_classes = 2
    c.dataset.spacing = [1.0, 1.0, 1.0]          # fixed world spacing (mm)
    c.dataset.crop_size = [96, 96, 96]           # voxels, divisible by max_stride
    c.dataset.sampling_method = "MASK"           # GLOBAL | MASK | CENTER | MIX
    c.dataset.random_translation = [5.0, 5.0, 5.0]  # jitter (mm)
    c.dataset.interpolation = "LINEAR"           # image interp (seg always NN)
    c.dataset.crop_normalizers = [FixedNormalizer(mean=0.0, stddev=1.0, clip=True)]
    c.dataset.random_flip = False                # axis-flip augmentation

    c.loss = EasyDict()
    c.loss.name = "Dice"                         # 'Dice' | 'Focal'
    c.loss.obj_weight = None                     # per-class weights
    c.loss.focal_obj_alpha = 0.25
    c.loss.focal_gamma = 2.0

    c.net = EasyDict()
    c.net.name = "vnet"

    c.train = EasyDict()
    c.train.epochs = 1000
    c.train.batchsize = 8
    c.train.num_threads = 1            # prefetch queue depth
    c.train.lr = 1e-4
    c.train.betas = (0.9, 0.999)
    c.train.save_epochs = 100

    c.debug = EasyDict()
    c.debug.save_inputs = False        # dump training crops as NIfTI

    # the JAX package's execution section: dtype is honoured, the rest is
    # checked (core/seg_train.py)
    c.tpu = EasyDict()
    c.tpu.mesh = EasyDict()
    c.tpu.mesh.data = -1               # -1 or 1: one device
    c.tpu.dtype = "float32"            # compute dtype: float32 | bfloat16

    return c
