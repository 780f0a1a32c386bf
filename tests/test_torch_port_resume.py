"""`train-gmmn --gmmn-resume` draws what the uninterrupted run draws.

zs3_tpu folds the step into the ZS3 step's key (`fold_in(rng,
gen_state.step)`), so a run resumed after step k draws step k + 1's
pixel scores and noise.  The port draws step `step`'s from a generator
of (seed, step) alone.  ResNet-50 at 33x33 on the CPU, 16 pixels per
class.  The tests compare the draws, not the weights: both packages
restart the loader's epoch on a resume, so the batches differ.
"""

import pytest
import torch

from zs3_tpu_torch import cli
from zs3_tpu_torch.train.gmmn import ZS3Step
from zs3_tpu_torch.utils.saver import Saver

TINY = ["train-gmmn", "--dataset", "synthetic", "--crop-size", "33", "--base-size", "33",
        "--backbone", "resnet50", "--compute-dtype", "float32", "--unseen-split", "2",
        "--batch-size", "4", "--pixels-per-class", "16", "--epochs", "1", "--no-val",
        "--device", "cpu"]


@pytest.fixture
def recorded(monkeypatch):
    """Every (step, draws) ZS3Step.draw returns, in order."""
    calls = []
    draw = ZS3Step.draw

    def spy(self, num_pixels, step):
        out = draw(self, num_pixels, step)
        calls.append((step, out))
        return out

    monkeypatch.setattr(ZS3Step, "draw", spy)
    return calls


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _differ(a, b):
    return not any(torch.equal(x, y) for x, y in zip(a, b))


def test_resumed_run_draws_the_next_step(tmp_path, recorded):
    _, whole = cli.run([*TINY, "--steps-per-epoch", "2",
                        "--checkpoint-dir", str(tmp_path / "whole")])
    assert whole.global_step == 2
    (s0, first), (s1, second) = recorded
    assert (s0, s1) == (0, 1)
    assert _differ(first, second)

    recorded.clear()
    _, part = cli.run([*TINY, "--steps-per-epoch", "1",
                       "--checkpoint-dir", str(tmp_path / "part")])
    ckpt = Saver.latest_checkpoint(part.saver.directory)
    assert ckpt.endswith("ckpt_00000001")
    assert _same(recorded[0][1], first)

    recorded.clear()
    _, resumed = cli.run([*TINY, "--steps-per-epoch", "1", "--gmmn-resume", ckpt,
                          "--checkpoint-dir", str(tmp_path / "resumed")])
    assert resumed.global_step == 2
    [(step, again)] = recorded
    assert step == 1
    assert _same(again, second)
    assert _differ(again, first)


@pytest.mark.parametrize("seed", [0, 3])
def test_draws_are_a_function_of_seed_and_step(tmp_path, seed):
    """Two trainers of one seed draw alike at every step, whatever they
    drew before; another seed draws otherwise."""
    def trainer(seed):
        return cli.run([*TINY, "--epochs", "0", "--seed", str(seed),
                        "--checkpoint-dir", str(tmp_path)])[1]

    a, b, other = trainer(seed), trainer(seed), trainer(seed + 1)
    pixels = 4 * 9 * 9
    b.step.draw(pixels, 0)  # b draws step 0 first, a does not
    for step in (0, 1, 5):
        assert _same(a.step.draw(pixels, step), b.step.draw(pixels, step))
        assert _differ(a.step.draw(pixels, step), other.step.draw(pixels, step))
    assert _differ(a.step.draw(pixels, 0), a.step.draw(pixels, 1))
