"""Device selection and float32 precision control."""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None, gpu_id: int = 0) -> torch.device:
    """The device an entry point runs on: ``device`` when given, the CPU for
    ``gpu_id < 0``, else ``cuda:<gpu_id>``; a CUDA device named without an
    index gets the current one. Raises when that needs a CUDA device and
    none is available — there is no silent CPU path."""
    if device is not None:
        dev = torch.device(device)
    elif gpu_id is not None and int(gpu_id) < 0:
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", int(gpu_id or 0))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (CLI: -g -1) "
                "to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"{dev} does not exist "
                               f"({torch.cuda.device_count()} CUDA device(s))")
    return dev


@contextlib.contextmanager
def no_tf32():
    """Full float32 convolutions and matmuls (cuDNN runs f32 convs in TF32
    by default); restores the previous settings on exit."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                        benchmark=torch.backends.cudnn.benchmark,
                                        deterministic=torch.backends.cudnn.deterministic,
                                        allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
