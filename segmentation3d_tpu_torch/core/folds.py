"""K-fold cross-validation management (``seg_train --folds K``).

The port of ``segmentation3d_tpu/core/folds.py``: one config file +
``--folds K`` splits the case list deterministically (seeded by
``cfg.general.seed``, the JAX package's split), trains fold ``k`` on the
other K-1 folds with fold ``k`` as ``cfg.train.val_list``, into
``<save_dir>_fold<k>``. Everything is written as plain files (the fold case
lists in the txt format + a wrapper config that runs the user's config and
overrides ``imseg_list``/``save_dir``/``val_list``), so a fold run is a
normal ``seg_train`` run; the wrapper runs through the port's
:func:`..utils.file_io.load_config`, whose aliases the user config sees.
Each file is written whole and then renamed into place, so the ranks of a
torchrun group, which all prepare the same fold, never read a half file.
"""
from __future__ import annotations

import os

import numpy as np


def split_folds(n_cases: int, k: int, seed: int = 0):
    """Deterministic shuffled partition of ``range(n_cases)`` into ``k``
    folds (sizes differ by at most 1). Same (n, k, seed) -> same split."""
    if k < 2:
        raise ValueError(f"--folds must be >= 2, got {k}")
    if n_cases < k:
        raise ValueError(f"{n_cases} case(s) cannot split into {k} folds")
    idx = np.random.default_rng(seed).permutation(n_cases)
    return [sorted(int(i) for i in idx[f::k]) for f in range(k)]


def _write_whole(path, text):
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)
    return path


def _write_case_list(path, ims, segs, indices):
    lines = [str(len(indices))]
    for i in indices:
        lines.extend(ims[i])
        lines.append(segs[i])
    return _write_whole(path, "\n".join(lines) + "\n")


def prepare_fold(config_file: str, k_folds: int, fold: int) -> str:
    """Write fold ``fold``'s files into ``<save_dir>_fold<fold>.setup/``
    (``train.txt``: the other folds, ``val.txt``: this fold, ``config.py``:
    the wrapper) and return the wrapper's path."""
    from segmentation3d_tpu_torch.dataloader.dataset import read_case_list
    from segmentation3d_tpu_torch.utils.file_io import load_config
    if not 0 <= fold < k_folds:
        raise ValueError(f"--fold {fold} out of range for --folds {k_folds}")
    cfg = load_config(config_file)
    ims, segs = read_case_list(cfg.general.imseg_list)
    folds = split_folds(len(ims), k_folds, seed=int(cfg.general.seed))
    val_idx = folds[fold]
    train_idx = sorted(i for f, fx in enumerate(folds) if f != fold
                       for i in fx)
    fold_dir = f"{cfg.general.save_dir}_fold{fold}"
    setup = fold_dir + ".setup"
    os.makedirs(setup, exist_ok=True)
    train_txt = _write_case_list(os.path.join(setup, "train.txt"),
                                 ims, segs, train_idx)
    val_txt = _write_case_list(os.path.join(setup, "val.txt"),
                               ims, segs, val_idx)
    wrapper = os.path.join(setup, "config.py")
    _write_whole(
        wrapper,
        f'''"""Auto-generated fold-{fold}/{k_folds} wrapper (seg_train --folds).
Runs the user config and overrides the fold-specific fields."""
import runpy as _runpy
cfg = _runpy.run_path(r"{os.path.abspath(config_file)}")["cfg"]
cfg.general.imseg_list = r"{train_txt}"
cfg.general.save_dir = r"{fold_dir}"
cfg.train.val_list = r"{val_txt}"
''')
    return wrapper


def train_folds(config_file: str, k_folds: int, fold: int | None = None,
                gpu_id: int = 0):
    """Train one fold (``fold`` given) or all K in turn, each as
    ``seg_train`` trains a config (:func:`..core.seg_train.train_ranks`)."""
    from segmentation3d_tpu_torch.core.seg_train import train_ranks
    targets = [fold] if fold is not None else list(range(k_folds))
    for k in targets:
        print(f"=== fold {k}/{k_folds} ===")
        train_ranks(prepare_fold(config_file, k_folds, k), gpu_id=gpu_id)
