"""Seen-class training in the port against zs3_tpu, continued: the train
step with the loss at the feature grid (labels resized nearest to the
logits' grid), remat and dropout.  The same setup and tolerances as
tests/test_torch_port_seen.py, whose helpers it uses."""

import numpy as np
import pytest
import torch

from zs3_tpu_torch.core.config import Config
from zs3_tpu_torch.models.deeplab import DeepLab, init_deeplab
from zs3_tpu_torch.train.seen import make_train_step
from zs3_tpu_torch.train.state import SegOptimizer
from zs3_tpu_torch.utils import losses

from tests.test_torch_port_models import LAYERS
from tests.test_torch_port_seen import (
    NUM_CLASSES,
    TOTAL_STEPS,
    _batch,
    _randomize_bn_stats,
    check_train_step_parity,
)
from tests.torch_port_threads import torch_one_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_feature_loss_train_step_matches_zs3_tpu(grad_accum):
    check_train_step_parity("feature", grad_accum)


def test_remat_changes_no_gradient_and_updates_bn_once():
    """model.remat runs each Bottleneck under torch.utils.checkpoint: the
    gradients and the BN running statistics equal those of the plain
    forward (the recompute leaves the statistics alone)."""
    batch = {k: torch.from_numpy(v) for k, v in _batch(5, bsz=2).items()}
    out = []
    for remat in (False, True):
        model = DeepLab(backbone="resnet50", num_classes=NUM_CLASSES, dropout=False,
                        layers=LAYERS, remat=remat)
        _randomize_bn_stats(init_deeplab(model, 0), seed=1)
        step = make_train_step(losses.build_seg_loss("ce"))
        step(model, SegOptimizer(model, Config(), TOTAL_STEPS), batch)
        out.append(model)
    plain, remat = (dict(m.named_parameters()) for m in out)
    for name, p in plain.items():
        np.testing.assert_allclose(remat[name].grad.numpy(), p.grad.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    for (name, a), b in zip(out[0].named_buffers(), out[1].buffers()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, atol=1e-7, err_msg=name)


def test_dropout_is_a_function_of_seed_and_step():
    """With dropout on, the same (seed, step) gives the same update and
    another step or seed other masks."""
    batch = {k: torch.from_numpy(v) for k, v in _batch(6, bsz=2).items()}
    model = DeepLab(backbone="resnet50", num_classes=NUM_CLASSES, dropout=True, layers=LAYERS)
    init = {k: v.clone() for k, v in init_deeplab(model, 0).state_dict().items()}
    losses_at = []
    for seed, step0 in ((0, 0), (0, 0), (0, 1), (1, 0)):
        model.load_state_dict(init)
        optimizer = SegOptimizer(model, Config(), TOTAL_STEPS)
        optimizer.step = step0
        out = make_train_step(losses.build_seg_loss("ce"), seed=seed)(model, optimizer, batch)
        losses_at.append(float(out["loss"]))
    assert losses_at[0] == losses_at[1]
    assert losses_at[2] != losses_at[0] and losses_at[3] != losses_at[0]
