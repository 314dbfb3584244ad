"""The port's losses, sampler and learning-rate schedules against the JAX
package's, on seeded numpy inputs.

Bars: loss values relative 1e-6 and gradients (``jax.grad`` against
autograd) within 1e-6 of their largest element, both float32 sums of a few
thousand terms; the sampler's index stream exactly; the learning rate per
step within 1e-6 of the initial rate against optax (optax evaluates in
float32, the port in float64; near the end of a cosine decay 1 + cos
cancels).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from segmentation3d_tpu.dataloader.sampler import EpochConcateSampler as JaxSampler
from segmentation3d_tpu.losses import create_loss as jax_create_loss
from segmentation3d_tpu.config.config import default_config as jax_default_config
from segmentation3d_tpu.losses.dice import BinaryDiceLoss as JaxBinaryDice
from segmentation3d_tpu.losses.dice import multi_dice_loss as jax_dice
from segmentation3d_tpu.losses.focal import focal_loss as jax_focal
from segmentation3d_tpu_torch.config import EasyDict, default_config
from segmentation3d_tpu_torch.core.seg_train import make_schedule
from segmentation3d_tpu_torch.dataloader.sampler import EpochConcateSampler
from segmentation3d_tpu_torch.losses import BinaryDiceLoss, create_loss
from segmentation3d_tpu_torch.losses.dice import multi_dice_loss
from segmentation3d_tpu_torch.losses.focal import focal_loss


def _probs_and_target(nc, seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(2, 6, 7, 8, nc)).astype(np.float32)
    target = rng.integers(0, nc, size=(2, 6, 7, 8)).astype(np.int32)
    return logits, target


def _compare(jax_fn, port_fn, nc, seed):
    """Value and gradient w.r.t. the logits of ``loss(softmax(logits))``."""
    logits, target = _probs_and_target(nc, seed)
    jv, jg = jax.value_and_grad(
        lambda z: jax_fn(jax.nn.softmax(z, axis=-1), jnp.asarray(target)))(
            jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_(True)
    pv = port_fn(torch.softmax(z, dim=-1), torch.from_numpy(target))
    pv.backward()
    assert float(pv.detach()) == pytest.approx(float(jv), rel=1e-6)
    jg = np.asarray(jg)
    np.testing.assert_allclose(z.grad.numpy(), jg, rtol=0,
                               atol=1e-6 * np.abs(jg).max())


@pytest.mark.parametrize("nc,weights", [(2, None), (3, None), (3, [1.0, 2.0, 5.0])])
def test_dice_matches_jax(nc, weights):
    _compare(lambda p, t: jax_dice(p, t, weights)[0],
             lambda p, t: multi_dice_loss(p, t, weights)[0], nc, seed=nc)


def test_binary_dice_matches_jax():
    """1 - soft Dice of the foreground channel, as the class's own API."""
    _compare(lambda p, t: JaxBinaryDice()(p[..., 1], t),
             lambda p, t: BinaryDiceLoss()(p[..., 1], t), 2, seed=4)


def test_default_config_is_jaxs():
    """The same sections, keys and values (normalizers by their fields)."""
    def plain(c):
        if isinstance(c, dict):
            return {k: plain(v) for k, v in c.items()}
        if isinstance(c, (list, tuple)):
            return type(c)(plain(v) for v in c)
        if hasattr(c, "__dict__"):
            return (type(c).__name__, plain(vars(c)))
        return c
    assert plain(default_config()) == plain(jax_default_config())


@pytest.mark.parametrize("nc,alpha,gamma", [(2, [0.75, 0.25], 2.0),
                                            (3, None, 2.0), (3, 0.5, 1.5)])
def test_focal_matches_jax(nc, alpha, gamma):
    _compare(lambda p, t: jax_focal(p, t, alpha, gamma),
             lambda p, t: focal_loss(p, t, alpha, gamma), nc, seed=10 + nc)


@pytest.mark.parametrize("cfg", [
    dict(name="Dice", obj_weight=None),
    dict(name="Dice", obj_weight=[1.0, 3.0]),
    dict(name="Focal", obj_weight=None, focal_obj_alpha=0.3, focal_gamma=2.0),
    dict(name="Focal", obj_weight=[0.6, 0.4], focal_gamma=1.0),
])
def test_create_loss_matches_jax(cfg):
    cl = EasyDict(cfg)
    _compare(jax_create_loss(cl, 2), create_loss(cl, 2), 2, seed=20)


def test_create_loss_rejects_unknown():
    with pytest.raises(ValueError, match="unknown loss"):
        create_loss(EasyDict(name="CE"), 2)


@pytest.mark.parametrize("n,epochs,seed", [(5, 4, 0), (1, 3, 7), (17, 2, 3)])
def test_sampler_stream_is_jaxs(n, epochs, seed):
    got = list(EpochConcateSampler(n, epochs, seed=seed))
    assert got == list(JaxSampler(n, epochs, seed=seed))
    assert len(got) == len(EpochConcateSampler(n, epochs, seed=seed)) == n * epochs


@pytest.mark.parametrize("sched,optax_fn", [
    ({"name": "cosine"}, lambda lr, t: optax.cosine_decay_schedule(lr, t, 0.0)),
    ({"name": "cosine", "alpha": 0.1},
     lambda lr, t: optax.cosine_decay_schedule(lr, t, 0.1)),
    ({"name": "linear", "end_lr": 1e-5},
     lambda lr, t: optax.linear_schedule(lr, 1e-5, t)),
    ({"name": "step", "step_epochs": 2, "gamma": 0.5},
     lambda lr, t: optax.exponential_decay(lr, 2 * (10 // 3), 0.5,
                                           staircase=True)),
])
def test_lr_per_step_matches_optax(sched, optax_fn):
    """10 cases, 7 epochs, batch 3: total 23 steps, 3 per epoch; steps past
    the end hold the last value."""
    cfg = EasyDict(lr=3e-3, lr_scheduler=sched)
    lr = make_schedule(cfg, 10, 7, 3)
    want = optax_fn(3e-3, (10 * 7) // 3)
    for count in range(30):
        assert lr(count) == pytest.approx(float(want(count)), abs=1e-6 * 3e-3)


def test_constant_lr_and_unknown_schedule():
    assert make_schedule(EasyDict(lr=1e-3), 10, 2, 2)(5) == 1e-3
    with pytest.raises(ValueError, match="unknown lr_scheduler"):
        make_schedule(EasyDict(lr=1e-3, lr_scheduler={"name": "poly"}), 10, 2, 2)
