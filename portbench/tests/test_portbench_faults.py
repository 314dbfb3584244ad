"""A run with its timed path broken underneath comes out not correct.

Each test skips the look for a card and drives the rest of a run on the
CPU at a tiny size, in float32, where a sound run reads nothing but
round-off against the reference and comes out correct: first sound, then
with one fault planted in the program. Faults: an answer altered where it
is produced (inference and serving: one patch of each batch gets its
classes swapped), a step that leaves the state unchanged, and half of the
batch left out (training)."""
import contextlib

import pytest
import torch

from portbench.drivers import infer, serve, train
from portbench.tests.tiny import tiny_context


@contextlib.contextmanager
def swapped_answers():
    """The program's forward, with the classes of each batch's first
    patch swapped."""
    from segmentation3d_tpu_torch.core import seg_infer
    real = seg_infer.build_forward

    def broken(*a, **kw):
        fwd = real(*a, **kw)

        def wrong(x):
            p = fwd(x).clone()
            p[0] = p[0].flip(-1)
            return p
        return wrong
    seg_infer.build_forward = broken
    try:
        yield
    finally:
        seg_infer.build_forward = real
        seg_infer._SESSIONS.clear()


@pytest.mark.parametrize("cell,driver", [("vnet.infer_bf16", infer), ("vbnet.infer_bf16", infer),
                                         ("vnet.serve_bf16", serve)])
def test_an_altered_answer_is_not_correct(tmp_path, cell, driver):
    from segmentation3d_tpu_torch.core import seg_infer
    seg_infer._SESSIONS.clear()
    sound = driver.run(tiny_context(cell, tmp_path, dtype="float32"))
    assert sound["correct"], sound["checks"]
    with swapped_answers():
        broken = driver.run(tiny_context(cell, tmp_path, dtype="float32"))
    assert not broken["correct"], broken["checks"]


@contextlib.contextmanager
def planted(step):
    from segmentation3d_tpu_torch.core import seg_train
    real = seg_train.train_step
    seg_train.train_step = lambda *a, **kw: step(real, *a, **kw)
    try:
        yield
    finally:
        seg_train.train_step = real


def unchanged(real, net, optimizer, loss_fn, images, segs, **kw):
    """The step's loss, with the optimizer's update undone."""
    before = [p.detach().clone() for p in net.parameters()]
    loss = real(net, optimizer, loss_fn, images, segs, **kw)
    with torch.no_grad():
        for p, b in zip(net.parameters(), before):
            p.copy_(b)
    return loss


def half_batch(real, net, optimizer, loss_fn, images, segs, **kw):
    b = images.shape[0] // 2
    return real(net, optimizer, loss_fn, images[:b], segs[:b], **kw)


def test_training_faults_are_not_correct(tmp_path):
    sound = train.run(tiny_context("vnet.train_bf16", tmp_path, dtype="float32"))
    assert sound["correct"], sound["checks"]
    for fault in (unchanged, half_batch):
        with planted(fault):
            broken = train.run(tiny_context("vnet.train_bf16", tmp_path, dtype="float32"))
        assert not broken["correct"], (fault.__name__, broken["checks"])
