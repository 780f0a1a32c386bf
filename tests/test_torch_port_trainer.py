"""SeenTrainer in the port: fit end to end, a bit-deterministic resume,
fine-tuning, the best metric carried across a resume, --no-val still
saving, and both checkpoint formats for --resume.  ResNet-50 at 33x33
in f32 on the CPU, with tests/test_torch_port_saver.py's helpers."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from zs3_tpu_torch.data.loader import make_val_loader
from zs3_tpu_torch.train.seen import SeenTrainer, build_eval_model, evaluate, validate
from zs3_tpu_torch.utils.saver import Saver

from tests.test_torch_port_saver import _assert_same, _cfg, _weights
from tests.torch_port_threads import torch_one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A SeenTrainer fitted for 2 epochs of 1 step, validating after each."""
    cfg = _cfg(tmp_path_factory.mktemp("seen"))
    trainer = SeenTrainer(cfg, device="cpu")
    return cfg, trainer, trainer.fit()


def test_seen_trainer_fit_end_to_end(trained):
    cfg, trainer, result = trained
    assert {"train_loss", "miou", "seen_miou", "unseen_miou", "harmonic_miou"} <= result.keys()
    assert all(np.isfinite(v) for v in result.values())
    assert trainer.step == 2
    exp = trainer.saver.directory
    assert Saver.latest_checkpoint(exp).endswith("ckpt_00000002")
    assert os.path.exists(os.path.join(exp, "ckpt_00000001"))
    meta = Saver.read_meta(Saver.latest_checkpoint(exp))
    assert meta["step"] == 2 and meta["epoch"] == 1 and meta["miou"] == result["miou"]
    assert meta["best_metric"] == trainer.best_metric > 0
    assert Saver.best_checkpoint(exp) is not None
    records = [json.loads(x) for x in open(os.path.join(exp, "metrics.jsonl"))]
    assert [r["step"] for r in records if "train_step/loss" in r] == [1, 2]
    assert sum("val/miou" in r for r in records) == 2
    payload = Saver.restore(Saver.latest_checkpoint(exp))
    assert payload["step"] == 2 and payload["optimizer"]["step"] == 2
    _assert_same(payload["model"], _weights(trainer.model))


def test_resume_is_bit_deterministic(tmp_path):
    """2 epochs straight == 1 epoch, checkpoint, resume, 1 epoch (dropout on:
    its masks are a function of (seed, step); the epoch order of (seed,
    epoch))."""
    cfg = _cfg(tmp_path, eval_interval=100)
    straight = SeenTrainer(cfg, device="cpu")
    straight.train_epoch(0)
    straight.train_epoch(1)
    first = SeenTrainer(cfg, device="cpu")
    first.train_epoch(0)
    path = first.saver.save_checkpoint(first.checkpoint_payload(), first.step, 0.0)
    resumed = SeenTrainer(cfg.replace(train=dataclasses.replace(cfg.train, resume=path)),
                          device="cpu")
    assert resumed.step == 1
    resumed.train_epoch(1)
    _assert_same(_weights(resumed.model), _weights(straight.model))


def test_finetune_loads_weights_and_resets_the_step(trained, tmp_path):
    _, trainer, _ = trained
    ckpt = Saver.best_checkpoint(trainer.saver.directory)
    cfg = _cfg(tmp_path, resume=ckpt, finetune=True)
    tuned = SeenTrainer(cfg, device="cpu")
    assert tuned.step == 0 and tuned.best_metric == 0.0
    assert tuned.optimizer.sgd.state_dict()["state"] == {}
    _assert_same(_weights(tuned.model), Saver.restore(ckpt)["model"])


def test_best_metric_carries_across_a_resume(trained, tmp_path):
    _, trainer, _ = trained
    ckpt = Saver.latest_checkpoint(trainer.saver.directory)
    resumed = SeenTrainer(_cfg(tmp_path, resume=ckpt), device="cpu")
    assert resumed.step == 2
    assert resumed.best_metric == trainer.best_metric > 0
    momentum = resumed.optimizer.sgd.state_dict()["state"]
    assert len(momentum) == len(list(resumed.model.parameters()))


def test_no_val_still_saves(tmp_path):
    cfg = _cfg(tmp_path, epochs=1, eval_interval=10**9)
    trainer = SeenTrainer(cfg, device="cpu")
    result = trainer.fit()
    assert "miou" not in result and np.isfinite(result["train_loss"])
    ckpt = Saver.latest_checkpoint(trainer.saver.directory)
    assert ckpt.endswith("ckpt_00000001") and Saver.read_meta(ckpt)["epoch"] == 0
    assert Saver.best_checkpoint(trainer.saver.directory) is None


def test_evaluate_writes_a_checkpoint(tmp_path):
    """`evaluate` is SeenTrainer.validate(epoch=0), which saves (the repair of
    ROADMAP Queue 3; zs3_tpu/train/seen.py:443-449)."""
    cfg = _cfg(tmp_path)
    got = evaluate(cfg, device="cpu")
    (exp,) = (tmp_path / "synthetic" / cfg.train.checkname).iterdir()
    ckpt = Saver.latest_checkpoint(str(exp))
    assert ckpt.endswith("ckpt_00000000")
    assert Saver.read_meta(ckpt)["miou"] == got["miou"]
    model = build_eval_model(cfg, "cpu")
    _assert_same(Saver.restore(ckpt)["model"], _weights(model))
    want = validate(model, make_val_loader(cfg.data)[0], 21, cfg.data, "cpu")
    assert got == want


def test_build_eval_model_reads_saver_and_bare_checkpoints(trained, tmp_path):
    cfg, trainer, _ = trained
    ckpt = Saver.latest_checkpoint(trainer.saver.directory)
    bare = tmp_path / "bare.pt"
    torch.save(Saver.restore(ckpt)["model"], bare)
    for path in (ckpt, str(bare)):
        model = build_eval_model(cfg.replace(train=dataclasses.replace(cfg.train, resume=path)),
                                 "cpu")
        _assert_same(_weights(model), _weights(trainer.model))
