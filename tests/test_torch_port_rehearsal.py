"""The port's release rehearsal (zs3_tpu_torch/release_rehearsal.py) and
the helpers it brought over from zs3_tpu.

- `assert_rehearsal_bars` against every failure mode of
  tests/test_rehearsal_bars.py, and zs3_tpu's acceptance rules
  (tests/test_zero_shot_acceptance.py), on the port's own healthy runs and
  its measured no-op runs;
- `fabricate_torchvision_resnet_state` bit-equal to zs3_tpu's, and
  `convert-weights` of the port and of zs3_tpu on one fabricated `.pth`
  giving trunks whose f32 forwards agree;
- `random_rotate`, `fixed_resize`, `decode_seg_map_sequence` and
  `encode_segmap` against zs3_tpu's on the same inputs and generators;
- `rehearse` on the CPU at ResNet-50 65² through every CLI stage.  With
  the synthetic stage at smoke depth it takes some 110 s on one thread,
  over tier-1's 90 s a test: that run, the zero-shot acceptance at
  20/45/30 epochs with the port's CPU bars, and the Pascal-Context
  graph-context chain are slow tests, as zs3_tpu's are;
- slow too: zs3_tpu's synthetic states carried into the port validate
  alike, and zs3_tpu's one-pass seen stage from one init matches the
  port's.
"""

import dataclasses
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_threads import torch_one_thread  # noqa: F401 (autouse)
from zs3_tpu.data import fabricate as jax_fabricate
from zs3_tpu.data import transforms as jax_transforms
from zs3_tpu.utils import viz as jax_viz
from zs3_tpu_torch import cli
from zs3_tpu_torch import release_rehearsal as rr
from zs3_tpu_torch.data import fabricate, transforms
from zs3_tpu_torch.utils import viz

# A healthy rehearsal on the card (`python -m zs3_tpu_torch.release_rehearsal
# --measure 3`, NVIDIA H100 80GB HBM3, 700.00 W; its three runs gave the
# same values), and the no-op runs measured beside it.
GOOD = {
    "evaluate_miou": 0.09636876352758565,
    "evaluate_int8_miou": 0.08837565504722328,
    "int8_miou_delta": 0.008,
    "qat_int8_miou": 0.11853273044873183,
    "gmmn_tta_miou": 0.03348316163758789,
    "gmmn_tta_seen_miou": 0.037427808681020656,
    "gmmn_tta_unseen_miou": 0.0019259852901257707,
    "gmmn_tta_harmonic_miou": 0.0036634541012304576,
    "synthetic_seen_miou": 0.4767,
    "synthetic_seen_unseen_miou": 0.0,
    "synthetic_zs3_unseen_miou": 0.2062,
    "synthetic_zs3_harmonic_miou": 0.2718,
    "synthetic_zs3_seen_miou": 0.3986,
    "synthetic_zs3_int8_unseen_miou": 0.2052,
    "synthetic_zs3_int8_seen_miou": 0.3974,
    "synthetic_zs5_unseen_miou": 0.2289,
    "synthetic_zs5_harmonic_miou": 0.2856,
    "synthetic_zs5_seen_miou": 0.3797,
    "qat_full_lr_int8_miou": 0.11275600126179665,
}
NOOP = {
    "noop_evaluate_miou": 0.010883060087981893,  # train-seen at LR 0
    "noop_synthetic_zs3_unseen_miou": 0.0,  # the ZS3 leg at a generator LR of 0
    "noop_synthetic_zs3_harmonic_miou": 0.0,
}
# A healthy CPU run at the slow tests' depth (R50 65², batch 2, 32 seen
# steps; the synthetic stage at 20/45/30 epochs; 2 threads, the run of
# the three with the lowest transfer), and its no-op runs.
GOOD_CPU = {
    "evaluate_miou": 0.04214383249886208,
    "evaluate_int8_miou": 0.04214383249886208,
    "int8_miou_delta": 0.0,
    "qat_int8_miou": 0.04214383249886208,
    "gmmn_tta_miou": 0.02890278705164973,
    "gmmn_tta_seen_miou": 0.03334936967498046,
    "gmmn_tta_unseen_miou": 0.0,
    "gmmn_tta_harmonic_miou": 0.0,
    "synthetic_seen_miou": 0.4608,
    "synthetic_seen_unseen_miou": 0.0,
    "synthetic_zs3_unseen_miou": 0.0661,
    "synthetic_zs3_harmonic_miou": 0.1141,
    "synthetic_zs3_seen_miou": 0.4181,
    "synthetic_zs3_int8_unseen_miou": 0.0653,
    "synthetic_zs3_int8_seen_miou": 0.4185,
    "synthetic_zs5_unseen_miou": 0.2981,
    "synthetic_zs5_harmonic_miou": 0.3499,
    "synthetic_zs5_seen_miou": 0.4234,
    "qat_full_lr_int8_miou": 0.04214383249886208,
}
NOOP_CPU = {
    "noop_evaluate_miou": 0.007515520113119971,
    "noop_synthetic_zs3_unseen_miou": 0.0,
    "noop_synthetic_zs3_harmonic_miou": 0.0,
}
CARD = dict(seen_steps=25, zero_shot="full", device="cuda")
CPU_FULL = dict(seen_steps=25, zero_shot="full", device="cpu")
SMOKE = dict(seen_steps=1, zero_shot="smoke", device="cpu")
SHALLOW = dict(GOOD, evaluate_miou=0.0009, synthetic_zs3_unseen_miou=0.0)

# name -> (metrics, rehearsal, the assertion's message or None to pass)
BAR_CASES = {
    "healthy card run passes": (GOOD, CARD, None),
    "healthy card run with its no-op runs passes": ({**GOOD, **NOOP}, CARD, None),
    "healthy CPU run with its no-op runs passes": ({**GOOD_CPU, **NOOP_CPU}, CPU_FULL, None),
    "a CPU transfer under the CPU bars fails": (
        dict(GOOD_CPU, synthetic_zs3_unseen_miou=0.03, synthetic_zs3_int8_unseen_miou=0.03),
        CPU_FULL, "zero-shot transfer below"),
    "LR-0 no-op trainer fails the seen floor": (
        dict(GOOD, evaluate_miou=NOOP["noop_evaluate_miou"],
             evaluate_int8_miou=NOOP["noop_evaluate_miou"]), CARD, "learned nothing"),
    "a QAT fine-tune that falls to the untrained level fails": (
        dict(GOOD, qat_int8_miou=NOOP["noop_evaluate_miou"]), CARD, "QAT fine-tune damaged"),
    "zero unseen transfer fails": (
        dict(GOOD, synthetic_zs3_unseen_miou=0.0, synthetic_zs3_harmonic_miou=0.0), CARD,
        "zero-shot transfer below"),
    "a generator that never learns fails": (
        dict(GOOD, synthetic_zs3_unseen_miou=NOOP["noop_synthetic_zs3_unseen_miou"],
             synthetic_zs3_harmonic_miou=NOOP["noop_synthetic_zs3_harmonic_miou"]), CARD,
        "zero-shot transfer below"),
    "broken int8 protocol fails": (
        dict(GOOD, evaluate_int8_miou=0.30, int8_miou_delta=-0.266), CARD,
        "int8 protocol diverged"),
    "non-finite metric fails": (dict(GOOD, gmmn_tta_miou=float("nan")), CARD, "non-finite"),
    "negative metric fails": (dict(GOOD, gmmn_tta_miou=-0.1), CARD, "negative"),
    "CPU smoke skips the depth-gated bars": (SHALLOW, SMOKE, None),
    "CPU smoke still binds the int8 delta": (
        dict(SHALLOW, int8_miou_delta=0.2), SMOKE, "int8 protocol diverged"),
    "a bar at or under its no-op run fails": (
        dict(GOOD, noop_evaluate_miou=rr.SEEN_BARS["cuda"]["evaluate_miou"]), CARD,
        "does not fail its no-op run"),
    "unseen transfer before the generator fails": (
        dict(GOOD, synthetic_seen_unseen_miou=0.05), CARD, "transfer before the generator"),
    "a retrain that destroys the seen classes fails": (
        dict(GOOD, synthetic_zs3_seen_miou=0.2, synthetic_zs3_int8_seen_miou=0.2), CARD,
        "destroyed seen classes"),
    "int8 losing the transfer fails": (
        dict(GOOD, synthetic_zs3_int8_unseen_miou=0.5 * GOOD["synthetic_zs3_unseen_miou"]),
        CARD, "int8 eval lost"),
    "int8 shifting seen mIoU fails": (
        dict(GOOD, synthetic_zs3_int8_seen_miou=GOOD["synthetic_zs3_seen_miou"] - 0.06), CARD,
        "int8 eval shifted"),
    "ZS5 that does not improve a ZS3 below the ceiling fails": (
        dict(GOOD, synthetic_zs3_unseen_miou=0.14, synthetic_zs3_int8_unseen_miou=0.14,
             synthetic_zs5_unseen_miou=0.15), CARD, "ZS5 did not improve"),
    "ZS5 that degrades a ZS3 at the ceiling fails": (
        dict(GOOD, synthetic_zs3_unseen_miou=0.30, synthetic_zs3_int8_unseen_miou=0.30,
             synthetic_zs5_unseen_miou=0.26), CARD, "ZS5 degraded"),
    "ZS5 that holds a ZS3 at the ceiling passes": (
        dict(GOOD, synthetic_zs3_unseen_miou=0.30, synthetic_zs3_int8_unseen_miou=0.30,
             synthetic_zs5_unseen_miou=0.28), CARD, None),
}


@pytest.mark.parametrize("case", sorted(BAR_CASES))
def test_assert_rehearsal_bars(case):
    metrics, run, message = BAR_CASES[case]
    if message is None:
        rr.assert_rehearsal_bars(dict(metrics), **run)
    else:
        with pytest.raises(AssertionError, match=message):
            rr.assert_rehearsal_bars(dict(metrics), **run)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_every_bar_sits_between_its_noop_and_healthy_values(device):
    """The bars of each device against the measured runs of the fixtures:
    above the no-op runs, under the healthy ones."""
    good, noops = (GOOD, NOOP) if device == "cuda" else (GOOD_CPU, NOOP_CPU)
    bars = rr.rehearsal_bars(seen_steps=25, zero_shot="full", device=device)
    assert set(bars) == set(rr.SEEN_BARS.get(device, {})) | set(rr.ZERO_SHOT_BARS[device])
    assert ("evaluate_miou" in bars) == (device == "cuda")  # the CPU's 65² has no seen floor
    for key, bar in bars.items():
        assert bar < good[key], (key, bar, good[key])
    for noop, keys in rr.NOOPS.items():
        for key in set(keys) & set(bars):
            assert noops[noop] < bars[key], (noop, noops[noop], bars[key])


# ---- fabricated torchvision ResNet weights and convert-weights ------------------------

@pytest.mark.parametrize("depth,seed", [(50, 0), (50, 3), (101, 0), (101, 3)])
def test_fabricated_resnet_state_is_zs3_tpus(depth, seed):
    got = fabricate.fabricate_torchvision_resnet_state(depth, seed)
    want = jax_fabricate.fabricate_torchvision_resnet_state(depth, seed)
    assert list(got) == list(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype and got[key].shape == value.shape, key
        assert got[key].tobytes() == value.tobytes(), key
    assert got["fc.weight"].shape == (1000, 2048)
    with pytest.raises(ValueError, match="depth must be one of"):
        fabricate.fabricate_torchvision_resnet_state(34)


def test_convert_weights_gives_zs3_tpus_trunk(tmp_path):
    """One fabricated torchvision ResNet-50 .pth through the port's
    `convert-weights` and zs3_tpu's: the same backbone tensors, and f32
    backbone forwards within 1e-5 of max |feature|."""
    import orbax.checkpoint as ocp

    from zs3_tpu.cli import main as jax_main
    from zs3_tpu.core.config import ModelConfig as JaxModelConfig
    from zs3_tpu.models.deeplab import build_deeplab as jax_build_deeplab
    from zs3_tpu_torch.models.deeplab import build_deeplab
    from zs3_tpu_torch.train.seen import model_state_dict
    from zs3_tpu_torch.utils.convert import state_dict_from_flax
    from zs3_tpu_torch.utils.saver import Saver

    pth = fabricate.fabricate_torchvision_resnet_pth(str(tmp_path / "r50.pth"), depth=50, seed=2)
    loaded = torch.load(pth, weights_only=True)
    state = fabricate.fabricate_torchvision_resnet_state(50, 2)
    assert list(loaded) == list(state)
    assert all(np.array_equal(loaded[k].numpy(), v) for k, v in state.items())

    flags = ["--backbone", "resnet50", "--crop-size", "33", "--base-size", "33",
             "--compute-dtype", "float32", "--dataset", "synthetic"]
    port_out, jax_out = tmp_path / "port.pt", tmp_path / "jax_ckpt"
    cli.run(["convert-weights", pth, "--output", str(port_out), *flags, "--device", "cpu"])
    assert jax_main(["convert-weights", pth, "--output", str(jax_out), *flags]) == 0
    restored = ocp.StandardCheckpointer().restore(str(jax_out))
    variables = {"params": restored["params"], "batch_stats": restored["batch_stats"]}

    port_sd = model_state_dict(Saver.restore(str(port_out)))
    jax_sd = state_dict_from_flax(variables)
    # (flax keeps no num_batches_tracked; the port keeps the .pth's)
    backbone = [k for k in port_sd
                if k.startswith("backbone.") and not k.endswith("num_batches_tracked")]
    assert backbone and all(torch.equal(port_sd[k], jax_sd[k]) for k in backbone)

    cfg = cli.build_config(cli.make_parser().parse_args(["evaluate", *flags]))
    model = build_deeplab(cfg.model)
    model.load_state_dict(port_sd)
    model.eval()
    x = np.random.default_rng(3).standard_normal((2, 33, 33, 3)).astype(np.float32)
    with torch.no_grad():
        high, low = model.backbone(torch.from_numpy(x))
    jmodel = jax_build_deeplab(JaxModelConfig(backbone="resnet50", num_classes=21,
                                              compute_dtype="float32"))
    j_high, j_low = jmodel.apply(variables, jnp.asarray(x),
                                 method=lambda m, a: m.encoder(a, train=False))
    for got, want in ((high.numpy(), np.asarray(j_high)), (low.numpy(), np.asarray(j_low))):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# ---- transforms and palettes -----------------------------------------------------------

def _sample(seed, h=40, w=60, classes=5):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 255, (h, w, 3)).astype(np.uint8),
            "label": rng.integers(0, classes, (h, w)).astype(np.uint8)}


@pytest.mark.parametrize("seed,degree,fill", [(0, 15.0, 255), (1, 15.0, 255), (2, 45.0, 0),
                                              (3, 90.0, 255)])
def test_random_rotate_is_zs3_tpus(seed, degree, fill):
    sample = _sample(seed)
    got = transforms.random_rotate(sample, np.random.default_rng(seed), degree, fill)
    want = jax_transforms.random_rotate(sample, np.random.default_rng(seed), degree, fill)
    for key in ("image", "label"):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    if degree >= 45:
        assert fill in got["label"]  # the corners uncover


@pytest.mark.parametrize("size,hw", [(24, (40, 60)), (513, (375, 500)), (65, (500, 375))])
def test_fixed_resize_is_zs3_tpus(size, hw):
    sample = _sample(size, *hw)
    got, want = transforms.fixed_resize(sample, size), jax_transforms.fixed_resize(sample, size)
    assert got["image"].shape == (size, size, 3) and got["label"].shape == (size, size)
    for key in ("image", "label"):
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("num_classes", [5, 21, 59])
def test_decode_seg_map_sequence_is_zs3_tpus(num_classes):
    rng = np.random.default_rng(num_classes)
    labels = rng.integers(0, num_classes, (3, 17, 23)).astype(np.int32)
    labels[:, :2] = 255  # ignore: black
    got = viz.decode_seg_map_sequence(labels, num_classes)
    assert got.shape == (3, 17, 23, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jax_viz.decode_seg_map_sequence(labels, num_classes))


@pytest.mark.parametrize("seed", [0, 1])
def test_encode_segmap_is_zs3_tpus(seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 21, (19, 29)).astype(np.uint8)
    rgb = viz.decode_segmap(labels, 21)
    rgb[3:6, 4:9] = (1, 2, 3)  # no VOC color: unmatched
    got = viz.encode_segmap(rgb)
    np.testing.assert_array_equal(got, jax_viz.encode_segmap(rgb))
    assert (got[3:6, 4:9] == 255).all()
    mask = np.ones_like(labels, bool)
    mask[3:6, 4:9] = False
    np.testing.assert_array_equal(got[mask], labels[mask])


# ---- the rehearsal end to end on the CPU -----------------------------------------------

STAGES = ["fabricate", "convert-weights", "train-seen", "train-gmmn", "train-zs5", "evaluate",
          "evaluate-int8", "qat-finetune+int8", "evaluate-gmmn+tta", "zero-shot-synthetic",
          "export", "serve"]
SUMMARY = {"ok", "backbone", "crop_size", "batch_size", "steps_per_stage", "seen_steps",
           "zero_shot_mode", "backend", "device_name", "tf32", "voc", "artifact_platforms",
           "metrics", "bars", "stage_seconds", "stage_launches", "total_seconds"}


def _check_summary(summary, stages):
    assert set(summary) == SUMMARY and summary["ok"] is True
    assert summary["backend"] == "cpu" and summary["artifact_platforms"] == ["cpu"]
    assert summary["voc"]["train_with_unseen"] > 0  # the unseen filter and tags engaged
    assert list(summary["stage_seconds"]) == stages == list(summary["stage_launches"])
    assert all(n == {"K1": 0, "K2": 0, "K3": 0} for n in summary["stage_launches"].values())
    assert set(summary["tf32"]) == {"cudnn", "matmul"}
    metrics = summary["metrics"]
    assert {"evaluate_miou", "evaluate_int8_miou", "int8_miou_delta",
            "qat_int8_miou"} <= set(metrics)
    assert abs(metrics["int8_miou_delta"]) <= rr.INT8_MIOU_DELTA
    assert any(k.startswith("gmmn_tta_") for k in metrics)
    assert summary["bars"] == {}  # no depth-gated bar at these depths


def test_rehearsal_cli_chain_on_the_cpu(tmp_path):
    """Every stage but the synthetic one (see the slow test below), at
    ResNet-50 65², batch 2, one step a stage."""
    summary = rr.rehearse(str(tmp_path), crop_size=65, batch_size=2, steps=1,
                          backbone="resnet50", device="cpu", zero_shot="off")
    _check_summary(summary, [s for s in STAGES if s != "zero-shot-synthetic"])
    assert summary["zero_shot_mode"] == "off" and summary["seen_steps"] == 1
    assert not any(k.startswith("synthetic_") for k in summary["metrics"])
    shutil.rmtree(tmp_path)  # some 2 GB of checkpoints


@pytest.mark.slow
def test_rehearsal_on_the_cpu_with_the_synthetic_stage(tmp_path, capsys):
    """The acceptance command's rehearsal through main(): every stage, the
    synthetic one at smoke depth (2/3/2 epochs, no bars)."""
    assert rr.main(["--device", "cpu", "--backbone", "resnet50", "--crop-size", "65",
                    "--batch-size", "2", "--workdir", str(tmp_path)]) == 0
    shutil.rmtree(tmp_path)  # some 2 GB of checkpoints
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    _check_summary(summary, STAGES)
    assert summary["zero_shot_mode"] == "smoke" and summary["crop_size"] == 65
    assert {"synthetic_seen_miou", "synthetic_seen_unseen_miou", "synthetic_zs3_unseen_miou",
            "synthetic_zs3_harmonic_miou", "synthetic_zs3_seen_miou",
            "synthetic_zs3_int8_unseen_miou", "synthetic_zs3_int8_seen_miou",
            "synthetic_zs5_unseen_miou", "synthetic_zs5_harmonic_miou",
            "synthetic_zs5_seen_miou"} == {k for k in summary["metrics"]
                                           if k.startswith("synthetic_")}


@pytest.mark.slow
def test_zero_shot_transfer_end_to_end(tmp_path):
    """tests/test_zero_shot_acceptance.py on the port: seen training, the
    ZS3 leg at 45 epochs, its int8 validation and ZS5 at 30, on the
    synthetic split, held to the port's CPU bars and zs3_tpu's rules."""
    zs = rr.synthetic_zero_shot(str(tmp_path), (20, 45, 30), device="cpu")
    rr.assert_zero_shot_transfer({f"synthetic_{k}": v for k, v in zs.items()}, "cpu")


@pytest.mark.slow
def test_context_graph_rehearsal_cli(tmp_path):
    """tests/test_release_rehearsal.py::test_context_graph_rehearsal_cli on
    the port: Pascal-Context and --graph-context through the CLI on a
    fabricated 59-class VOC2010 tree: train-seen -> train-gmmn
    --graph-context -> evaluate-gmmn."""
    from zs3_tpu_torch.data.classes import CONTEXT_CLASSES
    from zs3_tpu_torch.models.gmmn import GraphContextGMMN

    root = str(tmp_path / "data")
    stats = fabricate.fabricate_context_tree(root)
    assert stats["train_with_unseen"] > 0
    emb = fabricate.fabricate_embedding_npy(str(tmp_path / "w2v_ctx.npy"), CONTEXT_CLASSES,
                                            dim=300)
    run = str(tmp_path / "run")
    common = ["--dataset", "context", "--data-root", root, "--backbone", "resnet50",
              "--crop-size", "65", "--base-size", "65", "--batch-size", "8",
              "--unseen-split", "2", "--compute-dtype", "float32", "--checkpoint-dir", run,
              "--checkname", "ctx", "--device", "cpu"]
    sched = ["--epochs", "1", "--steps-per-epoch", "1"]
    cli.run(["train-seen", *common, *sched])
    seen = rr.best_or_latest(run, "context", "ctx")
    _, trainer = cli.run(["train-gmmn", "--resume", seen, "--graph-context",
                          "--embedding-path", emb, *common, *sched])
    assert isinstance(trainer.generator, GraphContextGMMN)
    gmmn = rr.best_or_latest(run, "context", "ctx-gmmn")
    report, _ = cli.run(["evaluate-gmmn", "--resume", seen, "--gmmn-resume", gmmn,
                         "--graph-context", "--embedding-path", emb, *common])
    assert np.isfinite(report["miou"]) and "harmonic_miou" in report
    # the gmmn stage recorded graph conditioning
    with open(os.path.join(os.path.dirname(gmmn), "config.json")) as f:
        assert json.load(f)["gmmn"]["graph_context"] is True


@pytest.mark.slow
def test_zs3_tpu_states_carry_into_the_port(tmp_path):
    """zs3_tpu's synthetic chain (tests/torch_port_reference_run.py, short)
    carried into the port: its seen trunk, and its ZS3 generator and
    classifier, validated by the port give zs3_tpu's own validation (the
    check `python -m tests.torch_port_reference_run OUT --port` makes on
    the card)."""
    from tests.torch_port_reference_run import reference_run
    from zs3_tpu_torch.train.seen import SeenTrainer

    out = tmp_path / "reference"
    want = reference_run(str(out), str(tmp_path / "zs3_tpu"), epochs=(2, 3, 2))
    trunk = str(out / "trunk.pt")
    cfg = rr.synthetic_config(str(tmp_path / "port"), 2)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, resume=trunk))
    seen = SeenTrainer(cfg, device="cpu").validate(0)
    trainer, _ = rr.synthetic_zs3(cfg, trunk, 0, "cpu")
    carried = torch.load(out / "zs3.pt", weights_only=True)
    trainer.generator.load_state_dict(carried["gen"])
    with torch.no_grad():
        for key, value in carried["cls"].items():
            trainer.step.cls[key].copy_(value)
    zs3 = trainer.validate(0)
    for got, ref in ((seen, want["seen"]), (zs3, want["zs3"])):
        for key in ("miou", "seen_miou", "unseen_miou", "harmonic_miou"):
            assert got[key] == pytest.approx(ref[key], abs=1e-6), (key, got, ref)


@pytest.mark.slow
def test_seen_stage_matches_zs3_tpu_from_one_init(tmp_path, capsys):
    """zs3_tpu's rehearsal's seen stage as it runs (one pass of the
    fabricated tree's 16 train images: 4 steps at batch 4), dropout off,
    from one init (zs3_tpu's convert-weights, carried over) on the same
    batches: the port and zs3_tpu evaluate alike.  At 4 steps both
    predict background everywhere: that stage's mIoU says which class a
    near-constant prediction lands on, not that the trunk learned."""
    import orbax.checkpoint as ocp

    from zs3_tpu.cli import main as jax_main
    from zs3_tpu_torch.core.config import Config
    from zs3_tpu_torch.utils.convert import state_dict_from_flax

    root = str(tmp_path / "data")
    fabricate.fabricate_voc_tree(root, n_train=12, n_val=4)
    fabricate.fabricate_sbd_tree(root, n=8)
    pth = fabricate.fabricate_torchvision_resnet_pth(str(tmp_path / "r50.pth"), depth=50)
    cfg = Config()
    config = tmp_path / "no_dropout.json"  # and zs3_tpu on one of the 8 test devices
    config.write_text(cfg.replace(
        model=dataclasses.replace(cfg.model, dropout=False),
        train=dataclasses.replace(cfg.train, mesh_axes=(("data", 1),))).to_json())
    flags = ["--config", str(config), "--dataset", "pascal", "--data-root", root, "--use-sbd",
             "--backbone", "resnet50", "--crop-size", "65", "--base-size", "65",
             "--batch-size", "4", "--unseen-split", "2", "--compute-dtype", "float32",
             "--seed", "0", "--epochs", "1", "--steps-per-epoch", "25"]
    init = str(tmp_path / "jax_init")
    assert jax_main(["convert-weights", pth, "--output", init, *flags,
                     "--checkpoint-dir", str(tmp_path / "jax_run")]) == 0
    restored = ocp.StandardCheckpointer().restore(init)
    port_init = str(tmp_path / "port_init.pt")
    torch.save({"model": state_dict_from_flax({"params": restored["params"],
                                               "batch_stats": restored["batch_stats"]})},
               port_init)
    capsys.readouterr()
    assert jax_main(["train-seen", "--resume", init, "--ft", *flags,
                     "--checkpoint-dir", str(tmp_path / "jax_run")]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got, trainer = cli.run(["train-seen", "--resume", port_init, "--ft", *flags,
                            "--checkpoint-dir", str(tmp_path / "port_run"), "--device", "cpu"])
    assert trainer.step == 4  # one pass of the loader, whatever --steps-per-epoch asks
    for key in ("miou", "seen_miou", "pixel_accuracy"):
        assert got[key] == pytest.approx(want[key], abs=1e-6), (key, got, want)
    shutil.rmtree(tmp_path)
