"""Each loop end to end at a tiny size on the CPU, against the plain
reference, and with each fault the cell can have planted underneath the
timed path: `correct` comes out false."""

import time

import pytest
import torch

from benchmark import faults, harness, inputs, spec
from benchmark.loops import train as train_loop
from benchmark.tests import tiny

SEED = 2**31 + 987654321  # wider than 32 signed bits, as the driver's are


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return spec.Spec(tiny.make_root(tmp_path_factory.mktemp("root")))


def run(root, cell, seconds=1.0):
    return harness.run_cell(root, cell, SEED, seconds, False, "cpu", time.perf_counter())


def test_loop_agrees_with_the_reference(root):
    cell = "tiny-r101-train"
    result = run(root, cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in root.end_to_end(cell)}
    assert list(result)[-1] == "checks"
    assert all(m["value"] > 0 for m in result["metrics"].values())


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_a_planted_fault_is_not_correct(root, fault):
    with faults.planted(fault):
        result = run(root, "tiny-r101-train")
    assert not result["correct"], result["checks"]
    assert result["failed"] >= 1


def test_xception_train_step_agrees_at_its_first_step(root):
    """At 33x33 Xception's BN sees a few values a channel in its middle
    flow, and the steps after the first amplify round-off (an f64 and an
    f32 reference part by 2% at step 2); the first step agrees."""
    config = root.config("tiny-xception")
    traffic = root.traffic("tiny-seen-train-b48")
    loop = train_loop.Loop(config, traffic, SEED, "cpu")
    prog = loop.program_readings()
    ref = train_loop.reference(config, traffic, SEED, "cpu")
    assert abs(prog["loss"][0] - ref["loss"][0]) <= 1e-5 * ref["loss"][0]
    assert set(prog["grad"]) == set(ref["grad"])
    keep = [n for n in train_loop.compare.kept_leaves(ref["grad"])]
    gap = train_loop.compare.worst_leaf(prog["grad"], ref["grad"], keep)
    assert gap < 1e-4


def test_program_and_reference_share_every_weight(root):
    """The same names and shapes, so the seeded weights are the same."""
    for name in ("tiny-r101", "tiny-xception"):
        config = root.config(name)
        with torch.device("meta"):
            from zs3_tpu_torch.models.deeplab import DeepLab
            from benchmark.reference import deeplab

            m = config["model"]
            program = DeepLab(backbone=m["backbone"], num_classes=m["num_classes"],
                              layers=m.get("layers"))
            reference = deeplab.build(config)
        want = {k: tuple(v.shape) for k, v in reference.state_dict().items()}
        assert {k: tuple(v.shape) for k, v in program.state_dict().items()} == want


def test_inputs_repeat_for_a_seed_and_differ_across_seeds(root):
    traffic = root.traffic("tiny-seen-train-b48")
    a = inputs.make_batches(traffic, 21, (10, 14), SEED, "cpu")
    b = inputs.make_batches(traffic, 21, (10, 14), SEED, "cpu")
    c = inputs.make_batches(traffic, 21, (10, 14), SEED + 1, "cpu")
    assert all(torch.equal(x["image"], y["image"]) and torch.equal(x["label"], y["label"])
               for x, y in zip(a, b))
    assert not torch.equal(a[0]["image"], c[0]["image"])
    labels = torch.cat([x["label"] for x in a])
    assert not ((labels == 10) | (labels == 14)).any()  # seen classes only
    assert (labels == inputs.IGNORE).any() and (labels == 0).any()
    # Rows all differ: no two images of the pool alike.
    images = torch.cat([x["image"] for x in a]).flatten(1)
    assert torch.cdist(images, images).fill_diagonal_(1).min() > 0


def test_ignore_share_is_about_voc_s():
    traffic = spec.Spec().traffic("seen-train-b48")
    batches = inputs.make_batches(dict(traffic, batch=4, pool_batches=2), 21, (10, 14), SEED,
                                  "cpu")
    share = float(torch.cat([b["label"] for b in batches]).eq(inputs.IGNORE).float().mean())
    assert 0.03 < share < 0.08


def test_seeded_weights_follow_the_rule():
    template = {"a.weight": torch.empty(64, 3, 7, 7), "bn.weight": torch.empty(64),
                "bn.bias": torch.empty(64), "bn.running_var": torch.empty(64),
                "bn.running_mean": torch.empty(64), "fc.bias": torch.empty(5)}
    state = inputs.seeded_state(template, SEED, "cpu")
    std = (1.0 / 147) ** 0.5 / 0.87962566103423978
    assert state["a.weight"].abs().max() <= 2 * std + 1e-6
    assert abs(float(state["a.weight"].std()) / std - 0.88) < 0.05
    assert torch.equal(state["bn.weight"], torch.ones(64))
    assert torch.equal(state["bn.running_var"], torch.ones(64))
    assert not state["bn.bias"].any() and not state["fc.bias"].any()


def test_the_fp8_reference_is_not_correct(root):
    """The train cells' control: the reference with every operation in fp8."""
    from benchmark import control

    config, traffic = root.config("tiny-r101"), root.traffic("tiny-seen-train-b48")
    ref = train_loop.reference(config, traffic, SEED, "cpu")
    lower = train_loop.compare_readings(
        control.readings(train_loop, config, traffic, SEED, "cpu", "fp8_reference"), ref)
    limits = root.limits("tiny-r101-train")
    assert any(lower[k] > limits[k] for k in limits), lower
