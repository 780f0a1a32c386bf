"""Checkpoints in the port: the Saver (zs3_tpu.utils.saver's semantics on
torch.save), the metric logger, the GMMN stage's checkpoints (a repair
that waited for the saver: train-gmmn saves, `--gmmn-resume` and
`evaluate-gmmn` work) and `cli train-seen` with `--auto-resume`.
ResNet-50 at 33x33 in f32 on the CPU, checkpoints under pytest's
tmp_path.  tests/test_torch_port_trainer.py holds SeenTrainer's own."""

import json
import os

import numpy as np
import pytest
import torch

from zs3_tpu_torch import cli
from zs3_tpu_torch.core.config import Config, DataConfig, ModelConfig, TrainConfig
from zs3_tpu_torch.train.seen import SeenTrainer
from zs3_tpu_torch.utils.logging import MetricLogger
from zs3_tpu_torch.utils.saver import Saver
from tests.torch_port_threads import torch_one_thread  # noqa: F401 (autouse)


def _cfg(tmp_path, **train):
    train = {"epochs": 2, "steps_per_epoch": 1, "log_every": 1,
             "checkpoint_dir": str(tmp_path), **train}
    return Config(
        model=ModelConfig(backbone="resnet50", compute_dtype="float32"),  # dropout on
        data=DataConfig(dataset="synthetic", crop_size=33, base_size=33, batch_size=2,
                        eval_batch_size=8, unseen_classes=(10, 14), num_workers=1,
                        synthetic_items=8),
        train=TrainConfig(**train),
    )


def _weights(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---- the Saver and the logger ----------------------------------------------------

def test_saver_experiments_best_gc_and_meta(tmp_path):
    cfg = Config()
    first = Saver(str(tmp_path), "synthetic", "run", cfg, keep=2)
    second = Saver(str(tmp_path), "synthetic", "run", keep=2)
    assert first.directory.endswith("experiment_0") and second.directory.endswith("experiment_1")
    with open(os.path.join(first.directory, "config.json")) as f:
        assert json.loads(f.read()) == json.loads(cfg.to_json())
    assert Saver.latest_experiment(str(tmp_path), "synthetic", "run") is None  # no checkpoint
    payload = lambda step: {"w": torch.full((3,), float(step)), "step": step}
    first.save_checkpoint(payload(1), 1, 0.5, is_best=True, extra={"epoch": 0})
    for step in (2, 3, 4):
        first.save_checkpoint(payload(step), step, 0.5)
    names = sorted(os.listdir(first.directory))
    # keep=2 keeps the newest two, and the best one besides.
    assert [n for n in names if n.startswith("ckpt_") and not n.endswith(".json")] == [
        "ckpt_00000001", "ckpt_00000003", "ckpt_00000004"]
    assert "ckpt_00000002.json" not in names
    best = Saver.best_checkpoint(first.directory)
    assert os.readlink(best) == "ckpt_00000001"
    assert Saver.read_meta(best) == {"step": 1, "best_metric": 0.5, "epoch": 0}
    restored = Saver.restore(best)
    assert restored["step"] == 1 and torch.equal(restored["w"], payload(1)["w"])
    assert Saver.latest_checkpoint(first.directory).endswith("ckpt_00000004")
    assert Saver.read_meta(str(tmp_path / "missing")) == {}
    # The newest experiment that holds a checkpoint.
    assert Saver.latest_experiment(str(tmp_path), "synthetic", "run") == first.directory
    second.save_checkpoint(payload(7), 7, 0.1, is_best=True)
    second.save_checkpoint(payload(8), 8, 0.2, is_best=True)
    assert os.readlink(Saver.best_checkpoint(second.directory)) == "ckpt_00000008"
    assert Saver.latest_experiment(str(tmp_path), "synthetic", "run") == second.directory
    assert Saver.latest_experiment(str(tmp_path), "synthetic", "other") is None


def test_metric_logger_writes_jsonl_and_tensorboard(tmp_path):
    logger = MetricLogger(str(tmp_path), tensorboard=True)
    logger.log(3, {"loss": 1.5, "harmonic_miou": None, "n": np.float32(2.0)}, prefix="val")
    logger.log_images(3, {"val/input": np.zeros((4, 5, 3), np.uint8)})
    logger.close()
    (line,) = open(tmp_path / "metrics.jsonl").read().splitlines()
    record = json.loads(line)
    assert record["step"] == 3 and record["val/loss"] == 1.5 and record["val/n"] == 2.0
    assert "val/harmonic_miou" not in record
    if logger._tb is not None:  # torch.utils.tensorboard imported
        assert os.listdir(tmp_path / "tb")


# ---- the GMMN stage and the CLI -----------------------------------------------------

TINY = ["--dataset", "synthetic", "--crop-size", "33", "--base-size", "33",
        "--backbone", "resnet50", "--compute-dtype", "float32", "--unseen-split", "2",
        "--batch-size", "4", "--eval-batch-size", "8", "--pixels-per-class", "16",
        "--device", "cpu"]


def test_gmmn_stage_saves_resumes_and_evaluates(tmp_path):
    """train-gmmn on a train-seen checkpoint saves after validation and
    under --no-val; --gmmn-resume restores the generator, the classifier,
    both optimizers, the step and the best harmonic mIoU; evaluate-gmmn
    runs on the CPU."""
    seen_flags = [a for a in TINY if a not in ("--pixels-per-class", "16")]
    _, seen = cli.run(["train-seen", *seen_flags, "--batch-size", "2", "--epochs", "1",
                       "--steps-per-epoch", "1", "--no-val", "--checkpoint-dir", str(tmp_path)])
    trunk = Saver.latest_checkpoint(seen.saver.directory)
    common = [*TINY, "--resume", trunk, "--checkpoint-dir", str(tmp_path)]
    result, trainer = cli.run(["train-gmmn", *common, "--epochs", "1", "--steps-per-epoch", "2"])
    assert trainer.global_step == 2 and "harmonic_miou" in result
    # The trunk is the checkpoint's; validation spliced the retrained classifier in.
    trunk_weights = lambda m: {k: v for k, v in _weights(m).items() if "classifier" not in k}
    _assert_same(trunk_weights(trainer.model), trunk_weights(seen.model))
    exp = trainer.saver.directory
    assert os.path.basename(os.path.dirname(exp)) == "deeplab-resnet101-gmmn"
    ckpt = Saver.latest_checkpoint(exp)
    assert ckpt.endswith("ckpt_00000002")
    assert Saver.read_meta(ckpt)["harmonic_miou"] == result["harmonic_miou"]
    _, no_val = cli.run(["train-gmmn", *common, "--epochs", "1", "--steps-per-epoch", "1",
                         "--no-val"])
    assert Saver.latest_checkpoint(no_val.saver.directory).endswith("ckpt_00000001")

    report, resumed = cli.run(["evaluate-gmmn", *common, "--gmmn-resume", ckpt])
    assert resumed.global_step == 2
    assert resumed.best_hiou == Saver.read_meta(ckpt)["best_metric"]
    _assert_same(_weights(resumed.generator), _weights(trainer.generator))
    for key in ("kernel", "bias"):
        assert torch.equal(resumed.step.cls[key].detach(), trainer.step.cls[key].detach())
    for opt in ("gen_opt", "cls_opt"):
        a = getattr(resumed.step, opt).state_dict()["state"]
        b = getattr(trainer.step, opt).state_dict()["state"]
        assert a.keys() == b.keys()
        for i in a:
            for k in a[i]:
                assert torch.equal(a[i][k], b[i][k]), (opt, i, k)
    assert report == {k: v for k, v in result.items() if k in report}
    # evaluate-gmmn saves too, under the next experiment.
    assert Saver.latest_checkpoint(resumed.saver.directory).endswith("ckpt_00000002")


def test_cli_train_seen_and_auto_resume(tmp_path):
    seen_flags = [a for a in TINY if a not in ("--pixels-per-class", "16")]
    argv = ["train-seen", *seen_flags, "--batch-size", "2", "--epochs", "1", "--steps-per-epoch", "1",
            "--no-val", "--checkpoint-dir", str(tmp_path), "--checkname", "seen",
            "--lr", "0.001", "--lr-scheduler", "cos", "--nesterov", "--loss-type", "focal",
            "--grad-accum", "2"]
    result, trainer = cli.run(argv)
    assert isinstance(trainer, SeenTrainer) and np.isfinite(result["train_loss"])
    cfg = trainer.cfg
    assert (cfg.optim.lr, cfg.optim.schedule, cfg.optim.nesterov, cfg.optim.loss_type,
            cfg.train.grad_accum) == (0.001, "cos", True, "focal", 2)
    _, again = cli.run(argv + ["--auto-resume"])
    assert again.cfg.train.resume == Saver.latest_checkpoint(trainer.saver.directory)
    assert again.step == 2
    # --qat, refused before the port had quantization: quantization-aware
    # training from the same flags (a fresh run: no --auto-resume).
    qat_result, qat_trainer = cli.run(argv + ["--qat", "--checkname", "qat"])
    assert qat_trainer.cfg.train.qat and qat_trainer.step == 1
    assert np.isfinite(qat_result["train_loss"])
