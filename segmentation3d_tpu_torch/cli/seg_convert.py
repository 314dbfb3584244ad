"""``seg_convert`` for the PyTorch/CUDA port — import a checkpoint trained
by the original PyTorch toolkit into the native checkpoint layout, once:

    python -m segmentation3d_tpu_torch.cli.seg_convert
        -i <model_dir | chk_dir | params.pth> -o <out_model_dir>

``seg_infer`` loads such checkpoints as they are, through the positional
importer (``compat/torch_import.py``), but redoes the import on every load.
The output is a native self-describing ``chk_<epoch>/params.pth`` with
``_kernel_layouts``, which loads in this package and in the JAX package.
The source payload must be self-describing (the toolkit's own
``save_checkpoint`` layout: net name, in/out channels, spacing,
interpolation, crop_normalizers, max_stride), as its model zoo ships it.
"""
from __future__ import annotations

import argparse
import os

from segmentation3d_tpu_torch.models import create_network
from segmentation3d_tpu_torch.utils import model_io
from segmentation3d_tpu_torch.utils.normalizer import normalizer_from_dict


def convert_checkpoint(input_path: str, out_model_dir: str) -> str:
    """Convert one checkpoint; returns the written chk dir."""
    if os.path.isfile(input_path):  # a bare params.pth
        chk = os.path.dirname(os.path.abspath(input_path))
    elif os.path.isfile(os.path.join(input_path, "params.pth")):
        chk = input_path
    else:  # a model dir: pick the latest epoch like seg_infer does
        chk = model_io.latest_checkpoint(input_path)
    payload = model_io.load_checkpoint_payload(chk)

    for key in ("net", "in_channels", "out_channels", "spacing",
                "crop_normalizers", "max_stride"):
        if key not in payload:
            raise ValueError(
                f"{chk}/params.pth is not a self-describing segmentation "
                f"checkpoint: missing '{key}'")

    net_kwargs = dict(payload.get("net_kwargs") or {})
    net_kwargs.pop("dtype", None)
    net = create_network(payload["net"], int(payload["in_channels"]),
                         int(payload["out_channels"]), **net_kwargs)
    state = payload["state_dict"]
    if "_kernel_layouts" in payload:
        print(f"{chk}: already in native layout; re-saving")
    else:
        from segmentation3d_tpu_torch.compat.torch_import import import_torch_state_dict
        state = import_torch_state_dict(state, net)
    net.load_state_dict(state, strict=True)

    out_chk = model_io.save_checkpoint(
        save_dir=out_model_dir,
        epoch_idx=int(payload.get("epoch_idx", 0)),
        batch_idx=int(payload.get("batch_idx", 0)),
        state_dict=net.state_dict(),
        net_name=payload["net"],
        max_stride=int(payload["max_stride"]),
        in_channels=int(payload["in_channels"]),
        out_channels=int(payload["out_channels"]),
        spacing=[float(s) for s in payload["spacing"]],
        interpolation=payload.get("interpolation", "LINEAR"),
        crop_normalizers=[normalizer_from_dict(d) for d in payload["crop_normalizers"]],
        extra={"net_kwargs": net_kwargs} if net_kwargs else None,
    )
    n_params = sum(t.numel() for t in net.state_dict().values())
    print(f"converted {chk} -> {out_chk} ({n_params:,} tensor elements)")
    return out_chk


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Convert a checkpoint of the original PyTorch toolkit to "
                    "the native layout (PyTorch/CUDA port)")
    parser.add_argument("-i", "--input", required=True,
                        help="model dir, chk_<epoch> dir, or params.pth file")
    parser.add_argument("-o", "--output", required=True,
                        help="output model directory")
    args = parser.parse_args(argv)
    return convert_checkpoint(args.input, args.output)


if __name__ == "__main__":
    main()
