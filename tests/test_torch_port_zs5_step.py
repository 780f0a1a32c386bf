"""One ZS5 step (`gmmn.self_training`, unseen pixels in the batch), plain
and graph-conditioned, against zs3_tpu's `make_zs3_step` with its draws
injected (ResNet-50 at 65x65, f32, the CPU): mmd and cls_ce to rtol 1e-4,
gradients and updated params to the tolerances of
tests/test_torch_port_zs3.py (tests/test_torch_port_graph.py's
`check_step_parity`).  A file of its own, so that the test workers share
the ZS5 tests."""

import numpy as np
import pytest

from zs3_tpu_torch.data.loader import make_train_loader

from tests.test_torch_port_graph import check_step_parity, step_configs
from tests.torch_port_threads import torch_one_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("graph", [False, True])
def test_zs5_step_matches_jax(graph, tmp_path):
    jcfg, cfg = step_configs(graph=graph, self_training=True,
                             weak_label_dir=str(tmp_path / "pseudo"))
    assert cfg.gmmn.self_training and cfg.data.weak_label_dir
    step = check_step_parity(jcfg, cfg)
    assert step.self_training and step.graph_context == graph


def test_zs5_step_batch_holds_unseen_pixels(tmp_path):
    """The step tests above see real unseen pixels: with a weak-label dir
    the train set keeps the unseen images (data/loader.py)."""
    _, cfg = step_configs(graph=False, self_training=True, weak_label_dir=str(tmp_path))
    batch = next(iter(make_train_loader(cfg.data)[0]))
    assert np.isin(batch["label"], (10, 14)).any()
    _, plain = step_configs(graph=False, self_training=False)
    for batch in make_train_loader(plain.data)[0]:
        assert not np.isin(batch["label"], (10, 14)).any()
