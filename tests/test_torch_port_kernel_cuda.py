"""The hand-written thin_conv3d kernel against its plain PyTorch version,
on a CUDA device. Imports no JAX, so it runs where only PyTorch is
installed:

    PYTHONPATH=. python -m pytest --noconftest -m cuda tests/test_torch_port_kernel_cuda.py

Tolerance 0.05 x max|ref| (tests/test_pallas_conv.py's bar); both sides
round their operands to bf16 and accumulate in float32, so the measured
error is one bf16 step of the output. An int8 output must match in more
than 99% of voxels and elsewhere differ by one step: only a sum that the
two accumulation orders put on opposite sides of a rounding midpoint may
differ, so a requant that truncated or rounded half away from zero fails.
"""
import numpy as np
import pytest
import torch

from segmentation3d_tpu_torch.models.fused_vnet import build_fused_forward
from segmentation3d_tpu_torch.models.vnet import SegmentationNet
from segmentation3d_tpu_torch.ops import thin_conv as tc

_TDT = {"bf16": torch.bfloat16, "f32": torch.float32, "int8": torch.int8}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(cin, cout, seed, shape, device):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape + (cin,)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, cin, cout)) * (2.0 / (27 * cin)) ** 0.5
         ).astype(np.float32)
    b = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    return (torch.from_numpy(a).to(device) for a in (x, w, b))


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,residual,out", [
    (1, 16, "none", "bf16"), (4, 16, "none", "f32"), (32, 2, "none", "f32"),
    (32, 32, "relu", "bf16"), (64, 64, "prelu", "f32"), (256, 256, "none", "int8"),
    (3, 5, "none", "f32"), (24, 8, "none", "bf16"),
])
def test_kernel_matches_plain(cuda_device, cin, cout, residual, out):
    x, w, b = _inputs(cin, cout, cin + cout, (2, 6, 10, 12), cuda_device)
    q = 20.0 if out == "int8" else None
    kw = dict(act="prelu", alpha=0.1, out_dtype=_TDT[out], residual=residual,
              res_alpha=0.2, quant_inv_sa=q)
    before = tc.thin_conv3d.launches
    got = tc.thin_conv3d(x, w, b, **kw)
    ref = tc.thin_conv3d_reference(x, w, b, **kw)
    torch.cuda.synchronize()
    assert tc.thin_conv3d.launches == before + 1
    assert got.dtype == _TDT[out] and got.shape == ref.shape
    err = (got.float() - ref.float()).abs().max().item()
    if out == "int8":
        assert err <= 1
        assert (got == ref).float().mean().item() > 0.99
    else:
        assert err <= 0.05 * ref.float().abs().max().item()


@pytest.mark.cuda
def test_folded_forward_on_card_matches_cpu(cuda_device):
    """The whole folded forward on the card (8 kernel launches for this
    net) against the same forward on the CPU (plain versions)."""
    net = SegmentationNet(1, 2, base_channels=4, down_convs=(1, 2),
                          up_convs=(2, 1)).eval()
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 16, 16, 16, 1)).astype(np.float32))
    cpu = build_fused_forward(net, torch.bfloat16)(x)
    before = tc.thin_conv3d.launches
    gpu = build_fused_forward(net.to(cuda_device), torch.bfloat16)(x.to(cuda_device))
    torch.cuda.synchronize()
    assert tc.thin_conv3d.launches == before + 8
    agree = (gpu.argmax(-1).cpu() == cpu.argmax(-1)).float().mean().item()
    assert agree > 0.98
    assert (gpu.cpu() - cpu).abs().max().item() < 0.1


def test_cpu_tensor_never_launches():
    """Without a card the wrapper runs the plain version for CPU tensors
    and counts no launch."""
    x, w, b = _inputs(4, 16, 1, (1, 4, 6, 16), "cpu")
    before = tc.thin_conv3d.launches
    got = tc.thin_conv3d(x, w, b, act="relu")
    assert torch.equal(got, tc.thin_conv3d_reference(x, w, b, act="relu"))
    assert tc.thin_conv3d.launches == before
