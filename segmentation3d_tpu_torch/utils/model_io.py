"""Checkpoint I/O — the JAX package's self-describing payload, in PyTorch.

The port's own copy of ``segmentation3d_tpu/utils/model_io.py``: the same
on-disk layout ``<save_dir>/checkpoints/chk_<epoch>/params.pth`` and the
same ``params.pth`` dict (``epoch_idx``, ``batch_idx``, ``net``,
``max_stride``, ``state_dict``, ``_kernel_layouts``, ``spacing``,
``interpolation``, ``in_channels``, ``out_channels``, ``crop_normalizers``),
so a checkpoint written by either package loads in the other.

The ``state_dict`` holds torch-named tensors in torch layouts (conv
``weight`` [O,I,kD,kH,kW], transposed-conv ``weight`` [I,O,kD,kH,kW] already
flipped into ``ConvTranspose3d``'s convention, BN running statistics and
``num_batches_tracked``). :func:`flatten_variables` / :func:`params_from_jax`
turn a flax variables tree (numpy leaves) into that dict.
"""
from __future__ import annotations

import glob
import os
import pickle
import re

import numpy as np
import torch


# ---------------------------------------------------------------------------
# flax variables (numpy leaves) -> torch-style flat state_dict
# ---------------------------------------------------------------------------

def _walk(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def flatten_variables(variables) -> tuple[dict, dict]:
    """Flax ``{'params': ..., 'batch_stats': ...}`` -> (state_dict of numpy
    arrays, layouts). Layout tags: ``conv`` (DHWIO -> OIDHW),
    ``conv_transpose`` (DHWIO -> IODHW, spatially flipped), ``linear``,
    ``tensor`` (stored as-is)."""
    state, layouts = {}, {}
    params = variables.get("params", {})
    stats = variables.get("batch_stats", {})

    for path, leaf in _walk(params):
        mods, leaf_name = path[:-1], path[-1]
        arr = np.asarray(leaf)
        name = ".".join(mods)
        if leaf_name == "kernel" and arr.ndim == 5:
            if any("up_conv" in m for m in mods):
                # flax ConvTranspose correlates; torch ConvTranspose3d
                # convolves — spatial axes flip between the two layouts
                state[f"{name}.weight"] = np.ascontiguousarray(
                    arr[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2))
                layouts[f"{name}.weight"] = "conv_transpose"
            else:
                state[f"{name}.weight"] = np.ascontiguousarray(arr.transpose(4, 3, 0, 1, 2))
                layouts[f"{name}.weight"] = "conv"
        elif leaf_name == "kernel":
            state[f"{name}.weight"] = np.ascontiguousarray(arr.T)
            layouts[f"{name}.weight"] = "linear"
        elif leaf_name == "scale":
            state[f"{name}.weight"] = arr
            layouts[f"{name}.weight"] = "tensor"
        elif leaf_name == "bias":
            state[f"{name}.bias"] = arr
            layouts[f"{name}.bias"] = "tensor"
        else:  # e.g. prelu alpha
            state[f"{name}.{leaf_name}"] = arr
            layouts[f"{name}.{leaf_name}"] = "tensor"

    for path, leaf in _walk(stats):
        mods, leaf_name = path[:-1], path[-1]
        name = ".".join(mods)
        suffix = {"mean": "running_mean", "var": "running_var"}.get(leaf_name, leaf_name)
        state[f"{name}.{suffix}"] = np.asarray(leaf)
        layouts[f"{name}.{suffix}"] = "tensor"
        if suffix == "running_var":
            state[f"{name}.num_batches_tracked"] = np.asarray(0, np.int64)
            layouts[f"{name}.num_batches_tracked"] = "tensor"
    return state, layouts


def params_from_jax(variables) -> dict:
    """Flax variables (numpy or array leaves) -> a state_dict of torch
    tensors that the port's ``SegmentationNet`` loads with
    ``load_state_dict(strict=True)``."""
    state, _ = flatten_variables(variables)
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


def layouts_of(state_dict) -> dict:
    """The ``_kernel_layouts`` side table for a torch state_dict, as
    :func:`flatten_variables` writes it."""
    layouts = {}
    for k, v in state_dict.items():
        mods = k.split(".")[:-1]
        if k.endswith(".weight") and v.dim() == 5:
            layouts[k] = ("conv_transpose" if any("up_conv" in m for m in mods)
                          else "conv")
        elif k.endswith(".weight") and v.dim() == 2:
            layouts[k] = "linear"
        else:
            layouts[k] = "tensor"
    return layouts


# ---------------------------------------------------------------------------
# save / load / scan
# ---------------------------------------------------------------------------

def checkpoint_dir(save_dir: str, epoch_idx: int) -> str:
    return os.path.join(save_dir, "checkpoints", f"chk_{epoch_idx}")


def save_checkpoint(save_dir: str, epoch_idx: int, batch_idx: int, state_dict,
                    net_name: str, max_stride: int, in_channels: int,
                    out_channels: int, spacing, interpolation: str,
                    crop_normalizers, extra: dict | None = None) -> str:
    """Write ``chk_<epoch>/params.pth`` from a torch ``state_dict`` (e.g.
    ``net.state_dict()``) with the JAX package's payload. Returns the
    checkpoint directory. The write is atomic (tmp file + ``os.replace``)."""
    chk = checkpoint_dir(save_dir, epoch_idx)
    os.makedirs(chk, exist_ok=True)
    state = {k: v.detach().to("cpu").contiguous() for k, v in state_dict.items()}
    payload = {
        "epoch_idx": int(epoch_idx),
        "batch_idx": int(batch_idx),
        "net": net_name,
        "max_stride": int(max_stride),
        "state_dict": state,
        "_kernel_layouts": layouts_of(state),
        "spacing": [float(s) for s in spacing],
        "interpolation": interpolation,
        "in_channels": int(in_channels),
        "out_channels": int(out_channels),
        "crop_normalizers": [n.to_dict() for n in crop_normalizers],
    }
    if extra:
        payload.update(extra)
    params_path = os.path.join(chk, "params.pth")
    tmp_path = params_path + ".tmp"
    torch.save(payload, tmp_path)
    os.replace(tmp_path, params_path)
    return chk


def load_checkpoint_payload(chk_dir: str) -> dict:
    """Read a ``params.pth`` dict. Its ``state_dict`` comes back as torch
    tensors on the CPU, whichever package wrote it."""
    path = os.path.join(chk_dir, "params.pth")
    try:  # a plain pickle of numpy arrays (the JAX package without torch)
        with open(path, "rb") as f:
            payload = pickle.load(f)
    except (pickle.UnpicklingError, ModuleNotFoundError, AttributeError,
            EOFError, ValueError):  # a torch zip container
        payload = torch.load(path, map_location="cpu", weights_only=False)
    sd = payload.get("state_dict", {})
    payload["state_dict"] = {
        k: (v.detach().cpu() if isinstance(v, torch.Tensor)
            else torch.from_numpy(np.array(v)))
        for k, v in sd.items()}
    return payload


def resolve_checkpoint(model_dir: str, which=None) -> str:
    """Checkpoint dir for a selector: ``None``/``'latest'`` -> highest
    epoch; ``'best'`` -> ``chk_best``; an int or digit string -> ``chk_<n>``."""
    if which is None or which == "latest":
        return latest_checkpoint(model_dir)
    if which == "best":
        chk = os.path.join(model_dir, "checkpoints", "chk_best")
        if not os.path.isfile(os.path.join(chk, "params.pth")):
            raise FileNotFoundError(
                f"{chk} not found — train with cfg.train.save_best = True "
                "(and a val_list) to produce a best-validation checkpoint")
        return chk
    try:
        epoch = int(which)
    except (TypeError, ValueError):
        raise ValueError(f"checkpoint selector must be 'latest', 'best' or "
                         f"an epoch number, got {which!r}") from None
    chk = checkpoint_dir(model_dir, epoch)
    if not os.path.isfile(os.path.join(chk, "params.pth")):
        raise FileNotFoundError(f"no checkpoint at {chk}")
    return chk


def latest_checkpoint(model_dir: str) -> str:
    """Scan ``<model_dir>/checkpoints/chk_*`` for the highest epoch."""
    pattern = os.path.join(model_dir, "checkpoints", "chk_*")
    candidates = []
    for d in glob.glob(pattern):
        m = re.match(r".*chk_(\d+)$", d)
        if m and os.path.isfile(os.path.join(d, "params.pth")):
            candidates.append((int(m.group(1)), d))
    if not candidates:
        raise FileNotFoundError(f"no checkpoints found under {pattern}")
    return max(candidates)[1]
