"""The evaluate slice end to end: zs3_tpu's make_eval_step against the
port's on the same weights and the same synthetic val batches.

ResNet-50 at 65x65 in f32 on the CPU, 2 unseen classes.  Confusion
matrices must agree except for at most 0.1% of pixels (near-ties of the
argmax), and the validate metric dicts within 1e-3.
"""

import dataclasses

import jax
import numpy as np
import pytest

from zs3_tpu.core.config import Config as JaxConfig
from zs3_tpu.core.config import DataConfig as JaxDataConfig
from zs3_tpu.core.config import ModelConfig as JaxModelConfig
from zs3_tpu.data.loader import make_data_loader
from zs3_tpu.metrics.evaluator import Evaluator as JaxEvaluator
from zs3_tpu.models.deeplab import build_deeplab as jax_build_deeplab
from zs3_tpu.train.seen import make_eval_step as jax_make_eval_step
from zs3_tpu.train.state import create_seg_state
from zs3_tpu_torch.core.config import Config
from zs3_tpu_torch.data.loader import make_val_loader
from zs3_tpu_torch.models.deeplab import build_deeplab
from zs3_tpu_torch.ops import eval_kernels
from zs3_tpu_torch.train.seen import device_batch, make_eval_step, validate
from zs3_tpu_torch.utils.convert import state_dict_from_flax

from tests.test_torch_port_models import randomize_bn
from tests.torch_port_threads import torch_one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def slice_pair():
    jcfg = JaxConfig(
        model=JaxModelConfig(backbone="resnet50", compute_dtype="float32"),
        data=JaxDataConfig(
            dataset="synthetic", crop_size=65, base_size=65, eval_batch_size=8,
            unseen_classes=(10, 14), num_workers=1,
        ),
    )
    cfg = Config.from_json(jcfg.to_json())  # the port reads zs3_tpu's JSON
    jmodel = jax_build_deeplab(jcfg.model)
    state = create_seg_state(jmodel, jcfg, jax.random.key(0), (1, 65, 65, 3), 1)
    variables = randomize_bn(state.eval_variables(), seed=5)
    state = state.replace(params=variables["params"], batch_stats=variables["batch_stats"])
    model = build_deeplab(cfg.model)
    model.load_state_dict(state_dict_from_flax(variables))
    return jcfg, state, cfg, model.eval()


def test_val_batches_match(slice_pair):
    jcfg, _, cfg, _ = slice_pair
    _, jax_val, jax_n = make_data_loader(jcfg.data)
    val, n = make_val_loader(cfg.data)
    assert n == jax_n == 21 and len(val) == len(jax_val) == 2
    for ours, ref in zip(val, jax_val):
        np.testing.assert_array_equal(ours["image"], ref["image"])
        np.testing.assert_array_equal(ours["label"], ref["label"])


def test_eval_step_and_validate_match(slice_pair):
    jcfg, state, cfg, model = slice_pair
    val, n = make_val_loader(cfg.data)
    jax_step = jax_make_eval_step(n, jcfg.data.ignore_index)
    step = make_eval_step(n, cfg.data.ignore_index)
    ref_eval = JaxEvaluator(n, jcfg.data.ignore_index, jcfg.data.unseen_classes)
    for batch in val:
        ref = np.asarray(jax_step(state, batch)).astype(np.int64)
        got = step(model, device_batch(batch, "cpu")).numpy()
        ref_eval.add_confusion(ref)
        valid = int((batch["label"] != 255).sum())
        assert got.sum() == ref.sum() == valid
        moved = np.abs(got - ref).sum() // 2  # each moved pixel counts twice
        assert moved <= 0.001 * valid, f"{moved} of {valid} pixels differ"
    want = ref_eval.compute().as_dict()
    got = validate(model, val, n, cfg.data, device="cpu")
    assert got.keys() == want.keys() and "harmonic_miou" in got
    for key in want:
        assert np.isfinite(got[key])
        assert abs(got[key] - want[key]) <= 1e-3, key
    assert eval_kernels.upsample_argmax.launches == 0


def test_cli_evaluate_on_cpu(capsys, tmp_path):
    import json

    from zs3_tpu_torch import cli

    assert cli.main([
        "evaluate", "--dataset", "synthetic", "--crop-size", "33", "--backbone",
        "resnet50", "--compute-dtype", "float32", "--unseen-split", "2",
        "--eval-batch-size", "8", "--device", "cpu", "--checkpoint-dir", str(tmp_path),
    ]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"miou", "seen_miou", "unseen_miou", "harmonic_miou"} <= out.keys()
    assert all(np.isfinite(v) for v in out.values())
