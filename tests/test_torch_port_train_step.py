"""One training step of the port against the JAX package's, from the same
weights (flax variables -> ``params_from_jax``) on the same seeded batch,
in float32 on the CPU: JAX's jitted ``make_train_step`` /
``make_accum_train_step`` against the port's ``train_step``.

Bars (float32; JAX's CPU convolutions and PyTorch's sum in other orders):

- loss: relative 1e-5;
- BatchNorm ``running_mean`` / ``running_var`` after the step: within
  1e-5 of the tensor's largest value. The same check fails under
  ``BatchNorm3d``'s own rule (``running_var`` towards the UNBIASED
  variance), which :func:`test_unbiased_update_would_fail` shows at the
  deepest level (2^3 voxels x 2 samples per channel);
- SGD: every updated parameter within 1e-5 of the tensor's largest value,
  and the update itself within 1e-3 of its largest element, beyond the
  2 ulp of the parameters it is read off (measured <= 3e-4: BatchNorm's
  backward cancels, which amplifies the float32 rounding of the
  convolution sums);
- Adam: its first update is ``lr * g / (|g| + eps)``, about ``lr *
  sign(g)``, so an element whose gradient is rounding noise gets a full
  step of either sign. Every element within 0.05 of its tensor's largest
  update, and 99.9% of all elements within 1e-3 (measured: 5 of ~25,000
  elements above 1e-3, the largest 1.3%).

Conv biases that feed a BatchNorm get no gradient (BatchNorm subtracts the
batch mean), only rounding noise, so the update checks skip them. The
seeded nets have no BatchNorm channel whose variance is tiny against its
squared mean: flax differentiates its fast variance E[x^2] - E[x]^2 as
written, which loses the gradient's precision there (a seed with such a
channel puts JAX's gradients several percent off a float64 port's, the
float32 port's within 1e-4).

The case with one value per channel at the deepest level (batch 1, 16^3
through four stride-2 levels) checks the loss and the running statistics:
flax normalizes it to variance 0 where ``BatchNorm3d`` raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from segmentation3d_tpu.core.seg_train import make_accum_train_step, make_train_step
from segmentation3d_tpu.losses import create_loss as jax_create_loss
from segmentation3d_tpu.models.vnet import SegmentationNet as JaxNet
from segmentation3d_tpu_torch.config import EasyDict
from segmentation3d_tpu_torch.core.seg_train import train_step
from segmentation3d_tpu_torch.losses import create_loss
from segmentation3d_tpu_torch.models.vnet import SegmentationNet
from segmentation3d_tpu_torch.utils.model_io import params_from_jax
from test_torch_port_checkpoint import seeded_variables

KW3 = dict(base_channels=2, down_convs=(1, 2, 1), up_convs=(1, 2, 1))
KW4 = dict(base_channels=2, down_convs=(1, 1, 1, 1), up_convs=(1, 1, 1, 1))
LR = {"sgd": 0.1, "adam": 1e-3}


def _loss_cfg(name):
    return EasyDict(name=name, obj_weight=None, focal_obj_alpha=0.25,
                    focal_gamma=2.0)


def _batch(b, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, 16, 16, 16, 1)).astype(np.float32)
    y = (rng.random((b, 16, 16, 16)) < 0.3).astype(np.int32)
    return x, y


def _jax_step(act, kw, loss, opt_name, x, y, seed, accum=1):
    """(loss, updated state_dict as numpy, starting port net) after JAX's step."""
    v, net = seeded_variables(act, 1, 2, seed=seed, kw=kw)
    jnet = JaxNet(in_channels=1, out_channels=2, act=act, **kw)
    opt = optax.sgd(LR[opt_name]) if opt_name == "sgd" else optax.adam(LR[opt_name])
    lf = jax_create_loss(_loss_cfg(loss), 2)
    step = make_train_step(jnet, lf, opt) if accum == 1 else \
        make_accum_train_step(jnet, lf, opt, accum)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, v["batch_stats"])
    p2, s2, _, jloss = step(params, stats, opt.init(params), jnp.asarray(x),
                            jnp.asarray(y))
    want = params_from_jax({"params": jax.device_get(p2),
                            "batch_stats": jax.device_get(s2)})
    return float(jloss), {k: t.numpy() for k, t in want.items()}, net


def _port_step(net, loss, opt_name, x, y, accum=1):
    old = {k: t.clone().numpy() for k, t in net.state_dict().items()}
    opt = torch.optim.SGD(net.parameters(), lr=LR[opt_name]) if opt_name == "sgd" \
        else torch.optim.Adam(net.parameters(), lr=LR[opt_name], eps=1e-8)
    got = train_step(net, opt, create_loss(_loss_cfg(loss), 2),
                     torch.from_numpy(x), torch.from_numpy(y), accum=accum)
    return float(got), old, {k: t.numpy() for k, t in net.state_dict().items()}


def _no_gradient(name):
    """A conv bias feeding a BatchNorm (every conv bias but the head's)."""
    return name.endswith(".bias") and "bn" not in name \
        and not name.startswith("out_block.proj")


def _check_stats(got, want):
    for k in want:
        if "running" in k:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-5 * np.abs(want[k]).max(),
                                       err_msg=k)


def _check_updates(got, old, want, opt_name):
    off, total = 0, 0
    for k in want:
        if k.endswith("num_batches_tracked") or "running" in k or _no_gradient(k):
            continue
        dj, dp = want[k] - old[k], got[k] - old[k]
        scale = np.abs(dj).max()
        # an update read off float32 parameters is known to 2 ulp of them
        err = np.abs(dp - dj) - 2 * np.spacing(np.abs(want[k]).max())
        if opt_name == "sgd":
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=1e-5 * np.abs(want[k]).max(), err_msg=k)
            assert err.max() <= 1e-3 * scale, (k, err.max() / scale)
        else:
            assert err.max() <= 0.05 * scale, (k, err.max() / scale)
            off += int(np.sum(err > 1e-3 * scale))
            total += err.size
    if opt_name == "adam":
        assert off <= 1e-3 * total, (off, total)


CASES = [("relu", "Dice", "sgd"), ("prelu", "Focal", "sgd"),
         ("relu", "Focal", "adam"), ("prelu", "Dice", "adam"),
         ("leaky_relu", "Dice", "sgd")]


@pytest.mark.parametrize("act,loss,opt_name", CASES)
def test_train_step_matches_jax(act, loss, opt_name):
    x, y = _batch(2, seed=1)
    jloss, want, net = _jax_step(act, KW3, loss, opt_name, x, y, seed=5)
    ploss, old, got = _port_step(net, loss, opt_name, x, y)
    assert abs(ploss - jloss) <= 1e-5 * abs(jloss), (ploss, jloss)
    _check_stats(got, want)
    _check_updates(got, old, want, opt_name)


def test_unbiased_update_would_fail():
    """The running-statistics check tells flax's rule from BatchNorm3d's:
    moving the deepest level's running_var towards the unbiased variance
    (n / (n - 1) x the biased one, n = 2^3 x 2) leaves the bar."""
    x, y = _batch(2, seed=1)
    _, want, net = _jax_step("relu", KW3, "Dice", "sgd", x, y, seed=3)
    _, old, got = _port_step(net, "Dice", "sgd", x, y)
    key = "down_16.res.conv0.bn.running_var"
    n = 2 * 2 ** 3
    batch_var = (got[key] - 0.9 * old[key]) / 0.1
    unbiased = 0.9 * old[key] + 0.1 * batch_var * n / (n - 1)
    np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
    with pytest.raises(AssertionError):
        _check_stats({key: unbiased}, {key: want[key]})


def test_one_value_per_channel():
    """batch 1 through four stride-2 levels of a 16^3 crop: the deepest
    BatchNorm sees one value per channel (flax: variance 0)."""
    x, y = _batch(1, seed=2)
    jloss, want, net = _jax_step("relu", KW4, "Dice", "sgd", x, y, seed=4)
    ploss, _, got = _port_step(net, "Dice", "sgd", x, y)
    assert abs(ploss - jloss) <= 1e-5 * abs(jloss), (ploss, jloss)
    _check_stats(got, want)
    with pytest.raises(ValueError, match="more than 1 value per channel"):
        torch.nn.BatchNorm3d(4).train()(torch.zeros(1, 4, 1, 1, 1))


def test_grad_accum_matches_jax():
    """grad_accum_steps=2 against make_accum_train_step: per-microbatch
    BatchNorm statistics threaded through the microbatches, the mean
    gradient, one update, the mean loss."""
    x, y = _batch(4, seed=5)
    jloss, want, net = _jax_step("relu", KW3, "Dice", "sgd", x, y, seed=6,
                                 accum=2)
    ploss, old, got = _port_step(net, "Dice", "sgd", x, y, accum=2)
    assert abs(ploss - jloss) <= 1e-5 * abs(jloss), (ploss, jloss)
    _check_stats(got, want)
    _check_updates(got, old, want, "sgd")


def test_remat_matches_no_remat():
    """remat (checkpointed down/up blocks, recomputed in backward) gives the
    same step as no remat, and moves the running statistics once."""
    x, y = _batch(2, seed=7)
    results = []
    for remat in (False, True):
        torch.manual_seed(0)
        net = SegmentationNet(1, 2, remat=remat, **KW3)
        loss, old, got = _port_step(net, "Dice", "adam", x, y)
        results.append((loss, got))
    (l0, s0), (l1, s1) = results
    assert l0 == pytest.approx(l1, rel=1e-6)
    for k in s0:
        np.testing.assert_allclose(s1[k], s0[k], rtol=1e-6, atol=1e-7, err_msg=k)
    assert int(s1["in_block.conv.bn.num_batches_tracked"]) == 1
    assert int(s1["down_4.res.conv0.bn.num_batches_tracked"]) == 1


def test_leaky_relu_module_matches_flax():
    """The module's eval forward with act='leaky_relu' (slope 0.01)."""
    v, net = seeded_variables("leaky_relu", 1, 2, seed=8, kw=KW3)
    jnet = JaxNet(in_channels=1, out_channels=2, act="leaky_relu", **KW3)
    x, _ = _batch(2, seed=9)
    ref = np.asarray(jnet.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)
