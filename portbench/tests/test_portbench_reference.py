"""The plain reference against the program's module at a tiny size on the
CPU, and the harness's operation counts against forward-hook counts."""
import json
import os

import pytest
import torch

from portbench import flops
from portbench.manifest import HERE
from portbench.reference import lowp, nets, train_ref


def config(name, **net):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    cfg["net"].update(net)
    return cfg


def port_net(cfg):
    from segmentation3d_tpu_torch.models import create_network
    n = cfg["net"]
    return create_network(n["name"], n["in_channels"], n["num_classes"],
                          base_channels=n["base_channels"], down_convs=n["down_convs"],
                          up_convs=n["up_convs"])


def seeded_pair(name, seed=3):
    # VB-Net at the full base width: a quarter of 4 channels is one, whose
    # BatchNorm over a handful of values makes the gradient ill-conditioned
    cfg = config(name, base_channels=4 if name == "vnet" else 16)
    ref = nets.build(cfg)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for k, t in ref.state_dict().items():
            if t.is_floating_point():
                t.copy_(torch.rand(t.shape, generator=g) * 0.5 + 0.75 if "running_var" in k
                        else torch.randn(t.shape, generator=g) * 0.3)
    port = port_net(cfg)
    port.load_state_dict(ref.state_dict(), strict=True)
    return cfg, ref, port


@pytest.mark.parametrize("name", ["vnet", "vbnet"])
def test_the_reference_forward_is_the_programs(name):
    cfg, ref, port = seeded_pair(name)
    x = torch.randn(2, 1, 32, 32, 32, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = port.eval()(x.permute(0, 2, 3, 4, 1)).permute(0, 4, 1, 2, 3)
        got = ref.eval().probs(x)
    assert torch.allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("name", ["vnet", "vbnet"])
def test_a_reference_training_step_is_the_programs(name):
    from segmentation3d_tpu_torch.core.seg_train import train_step
    from segmentation3d_tpu_torch.losses import MultiDiceLoss
    cfg, ref, port = seeded_pair(name)
    start = {k: v.clone() for k, v in ref.state_dict().items()}
    g = torch.Generator().manual_seed(2)
    images = torch.randn(2, 32, 32, 32, 1, generator=g)
    segs = (torch.rand(2, 32, 32, 32, generator=g) > 0.7).to(torch.uint8)
    opt = torch.optim.Adam(port.parameters(), lr=1e-3, eps=1e-8, betas=(0.9, 0.999))
    loss = float(train_step(port, opt, MultiDiceLoss(num_class=2), images, segs))
    tr = {"lr": 1e-3, "betas": [0.9, 0.999]}
    losses, grad1, change = train_ref.reference_run(cfg, tr, start, [(images, segs)], "cpu")
    assert losses[0] == pytest.approx(loss, rel=1e-6)
    # the gradient as Adam holds it; a conv bias in front of BatchNorm has
    # a gradient of round-off alone, left out by the benchmark's own rule
    norms = {k: float(g.norm()) for k, g in grad1.items()}
    med = sorted(norms.values())[len(norms) // 2]
    kept = 0
    for k, p in port.named_parameters():
        if norms[k] < 1e-3 * med:
            continue
        got = opt.state[p]["exp_avg"] / 0.1
        # float32 round-off, grown by the BatchNorms of the deepest level,
        # which normalise over 16 values each at this size
        assert float((got - grad1[k]).norm()) <= 1e-2 * norms[k], k
        kept += 1
    assert kept > len(norms) // 2


@pytest.mark.parametrize("name", ["vnet", "vbnet"])
def test_operation_counts_equal_hook_counts(name):
    cfg = config(name)
    net = nets.build(cfg)
    counted = []

    def hook(m, inp, out):
        k = m.weight[0, 0].numel()
        if isinstance(m, torch.nn.ConvTranspose3d):
            counted.append(2 * inp[0].numel() * m.out_channels * k)
        else:
            counted.append(2 * out.numel() * m.in_channels * k)
    for m in net.modules():
        if isinstance(m, (torch.nn.Conv3d, torch.nn.ConvTranspose3d)):
            m.register_forward_hook(hook)
    with torch.no_grad():
        net.eval()(torch.zeros(1, 1, 32, 32, 32))
    assert sum(counted) == flops.forward_flops(cfg["net"], (32, 32, 32))
    want = 180.80464896e9 if name == "vnet" else 22.74656256e9
    assert flops.forward_flops(cfg["net"], (96, 96, 96)) == pytest.approx(want)
    stride1_3 = [m for m in net.modules() if isinstance(m, torch.nn.Conv3d)
                 and m.kernel_size == (3, 3, 3) and m.stride == (1, 1, 1)]
    assert len(flops.thin_conv_sites(cfg["net"])) == (len(stride1_3) if name == "vnet" else 0)


def test_the_fp8_control_rounds_and_keeps_names():
    cfg = config("vnet", base_channels=4)
    net = nets.build(cfg)
    low = lowp.low_net(net, "fp8")
    assert list(low.state_dict()) == list(net.state_dict())
    x = torch.randn(1, 1, 32, 32, 32)
    with torch.no_grad():
        a, b = net.eval().probs(x), low.eval().probs(x)
    assert 0 < float((a - b).abs().max()) < 0.5
    with torch.no_grad():
        c = lowp.low_net(net, "int8").eval().probs(x)
    assert 0 < float((a - c).abs().max()) < 0.5
    t = torch.linspace(-3, 3, 1001)
    q = lowp.fp8(t)
    # 3 mantissa bits: a value moves by at most a sixteenth of itself
    assert len(torch.unique(q)) < 256
    assert bool(((q - t).abs() <= t.abs() / 16 + 1e-6).all())
