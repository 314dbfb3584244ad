"""Config loading + logging utilities.

The port of ``segmentation3d_tpu/utils/file_io.py``: ``load_config`` (exec of
a python config file) and ``setup_logger`` (file + stdout logger writing
``<save_dir>/train_log.txt``).

Configs written for the original PyTorch toolkit or the JAX package import
``from easydict import EasyDict`` and ``from segmentation3d.utils.normalizer
import ...``. While one executes, :func:`load_config` points those names at
the port (``easydict`` at the port's ``EasyDict`` unless the real package is
installed) and afterwards puts ``sys.modules`` back as it found it. So a
process that also loads configs through the JAX package (whose loader
installs its own aliases for good) gets the port's normalizer objects from
the port's loader and the JAX objects from the JAX loader, in either order.
"""
from __future__ import annotations

import importlib
import importlib.machinery
import importlib.util
import logging
import os
import sys
import types

#: the names a config may import, and the port module each one means
_ALIASES = {
    "segmentation3d": "segmentation3d_tpu_torch",
    "segmentation3d.utils": "segmentation3d_tpu_torch.utils",
    "segmentation3d.utils.normalizer": "segmentation3d_tpu_torch.utils.normalizer",
    "segmentation3d.utils.file_io": "segmentation3d_tpu_torch.utils.file_io",
    "segmentation3d.loss": "segmentation3d_tpu_torch.losses",
    "segmentation3d.network": "segmentation3d_tpu_torch.models",
}


def _easydict_module():
    """The installed ``easydict`` package, else a module holding the port's
    ``EasyDict``."""
    # PathFinder looks at sys.path only: a shim another loader left in
    # sys.modules has no spec and would make importlib.util.find_spec raise
    if importlib.machinery.PathFinder.find_spec("easydict") is not None:
        return importlib.import_module("easydict")
    from segmentation3d_tpu_torch.config.config import EasyDict
    shim = types.ModuleType("easydict")
    shim.EasyDict = EasyDict
    return shim


def _port_aliases() -> dict:
    aliases = {name: importlib.import_module(target)
               for name, target in _ALIASES.items()}
    aliases["easydict"] = _easydict_module()
    return aliases


def load_config(config_file: str):
    """Execute a python config file with the port's aliases installed and
    return its ``cfg`` object."""
    config_file = os.path.abspath(config_file)
    if not os.path.isfile(config_file):
        raise FileNotFoundError(config_file)
    aliases = _port_aliases()
    saved = {name: sys.modules.get(name) for name in aliases}
    sys.modules.update(aliases)
    try:
        spec = importlib.util.spec_from_file_location("seg3d_user_config",
                                                      config_file)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        for name, mod in saved.items():
            if mod is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod
    if not hasattr(module, "cfg"):
        raise ValueError(f"{config_file} does not define a `cfg` object")
    return module.cfg


def setup_logger(log_file: str, name: str = "seg3d_torch", to_file: bool = True):
    """File + stdout logger: per-batch lines into ``train_log.txt``."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    for h in list(logger.handlers):
        h.close()
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s",
                            datefmt="%m-%d %H:%M:%S")
    if to_file:
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    logger.propagate = False
    return logger
