"""The port's SlidingWindowInferer vs the JAX one, float32, same weights.

With the flax forward inside both engines (the engine alone under test) the
masks are identical and the probabilities within 1e-4 (float32 rounding:
the JAX engine runs the forward inside one compiled scan). With the port's
own module forward the probabilities stay within 1e-4 and the masks differ
at most at argmax near-ties (top-two margin below 1e-4).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation3d_tpu.core import infer_engine as je
from segmentation3d_tpu_torch.core import infer_engine as te
from segmentation3d_tpu_torch.core.seg_infer import module_forward
from test_torch_port_checkpoint import jax_net, seeded_variables


@pytest.fixture(scope="module")
def nets():
    v, net = seeded_variables(out_ch=3, seed=3)
    return jax_net(out_ch=3), v, net


def phantom():
    """A noisy sphere on a background, [32,32,32,1]."""
    z, y, x = np.mgrid[0:32, 0:32, 0:32]
    rng = np.random.default_rng(1)
    inside = (z - 15) ** 2 + (y - 17) ** 2 + (x - 14) ** 2 < 81
    vol = np.where(inside, 1.0, -1.0) + rng.normal(0, 0.1, inside.shape)
    return vol[..., None].astype(np.float32)


@pytest.mark.parametrize("kind", ["gaussian", "constant"])
@pytest.mark.parametrize("patch", [(16, 16, 16), (8, 16, 24)])
def test_weight_map(kind, patch):
    np.testing.assert_array_equal(te.make_weight_map(patch, kind),
                                  je.make_weight_map(patch, kind))


@pytest.mark.parametrize("blend", ["gaussian", "constant"])
@pytest.mark.parametrize("patch,stride,batch", [
    ((16, 16, 16), (8, 8, 8), 3),
    ((16, 32, 16), (16, 16, 8), 8),
    ((32, 32, 32), None, 2),
])
def test_matches_jax_inferer(nets, patch, stride, batch, blend):
    jnet, v, net = nets
    vol = phantom()
    jinf = je.SlidingWindowInferer(jnet, patch, 3, batch_size=batch, blend=blend)

    def flax_forward(p):
        return torch.from_numpy(np.asarray(
            jnet.apply(v, jnp.asarray(p.numpy()), train=False)))
    tinf = te.SlidingWindowInferer(flax_forward, patch, 3, batch_size=batch,
                                   blend=blend)
    np.testing.assert_array_equal(tinf.boxes_for((32, 32, 32), stride),
                                  jinf.boxes_for((32, 32, 32), stride))
    jmask, jprob = jinf(v, jnp.asarray(vol), stride_zyx=stride, return_prob=True)
    tmask, tprob = tinf(torch.from_numpy(vol), stride_zyx=stride, return_prob=True)
    assert tmask.dtype == torch.uint8 and tprob.dtype == torch.float32
    np.testing.assert_allclose(tprob.numpy(), np.asarray(jprob), atol=1e-4)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))

    own = te.SlidingWindowInferer(module_forward(net, torch.float32), patch, 3,
                                  batch_size=batch, blend=blend)
    omask, oprob = own(torch.from_numpy(vol), stride_zyx=stride, return_prob=True)
    np.testing.assert_allclose(oprob.numpy(), np.asarray(jprob), atol=1e-4)
    top2 = np.sort(np.asarray(jprob), axis=-1)[..., -2:]
    differ = omask.numpy() != np.asarray(jmask)
    assert np.all(top2[..., 1][differ] - top2[..., 0][differ] < 1e-4)


def test_rejects_unknown_blend():
    with pytest.raises(ValueError):
        te.SlidingWindowInferer(lambda p: p, (8, 8, 8), 2, blend="median")
