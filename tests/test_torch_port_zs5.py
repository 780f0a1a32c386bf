"""ZS5 self-training in the port against zs3_tpu's.

* (One ZS5 step against zs3_tpu's: tests/test_torch_port_zs5_step.py.)
* Mirrors of tests/test_self_training.py: only tagged images get a PNG,
  unseen GT values are never read, the confidence threshold, the
  weak-label override, `_gt_view` undoing it.
* `generate_pseudo_labels` against zs3_tpu's on the same weights: the
  same files, and labels that differ on at most 0.1% of the pixels
  (near-ties of the argmax, as the ZS3 eval test bounds them).
* `train-zs5 --device cpu` writes under <checkname>-zs5, and
  `--auto-resume` never crosses the -gmmn and -zs5 stages.
* No message of the port cites a ROADMAP Queue 1 item number.
The ZS5 trainer end to end is a slow test, as the reference's is.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from zs3_tpu.data.synthetic import SyntheticSegmentation as JaxSynthetic
from zs3_tpu.models.deeplab import DeepLab as JaxDeepLab
from zs3_tpu.train import self_training as jax_st
from zs3_tpu_torch import cli
from zs3_tpu_torch.core.config import (
    Config, DataConfig, GMMNConfig, ModelConfig, TrainConfig,
)
from zs3_tpu_torch.data.synthetic import SyntheticSegmentation
from zs3_tpu_torch.models.deeplab import DeepLab, init_deeplab
from zs3_tpu_torch.train.self_training import (
    WeakLabelDataset, ZS5Trainer, _gt_view, generate_pseudo_labels, make_pseudo_label_step,
)
from zs3_tpu_torch.utils.convert import state_dict_from_flax
from zs3_tpu_torch.utils.saver import Saver

from tests.test_torch_port_graph import EVAL_TINY, TINY, small_config
from tests.test_torch_port_models import randomize_bn
from tests.torch_port_threads import torch_one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def model():
    """A seeded ResNet-50 DeepLab of 6 classes (pseudo-labelling never
    changes it)."""
    return init_deeplab(DeepLab(backbone="resnet50", num_classes=6, dropout=False), 0).eval()


def test_generate_pseudo_labels(model, tmp_path):
    ds = SyntheticSegmentation(8, (65, 65), num_classes=6, seed=3)
    out_dir = str(tmp_path / "pseudo")
    n = generate_pseudo_labels(model, ds, (2,), out_dir, size=65)
    expected = sum(1 for i in range(8) if (ds[i]["label"] == 2).any())
    assert n == expected and n > 0
    assert len(os.listdir(out_dir)) == n
    for i in range(8):
        sample = ds[i]
        path = os.path.join(out_dir, sample["name"] + ".png")
        if not (sample["label"] == 2).any():
            assert not os.path.exists(path)
            continue
        pseudo = np.asarray(Image.open(path))
        gt = sample["label"]
        assert pseudo.shape == gt.shape
        np.testing.assert_array_equal(pseudo[gt != 2], gt[gt != 2])
        assert np.all(np.isin(pseudo[gt == 2], [0, 1, 2, 3, 4, 5]))


class _StubDataset:
    def __init__(self, images, labels, num_classes):
        self.images, self.labels = images, labels
        self.NUM_CLASSES = num_classes
        self.names = [f"img_{i:03d}" for i in range(len(images))]

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return {"image": self.images[i], "label": self.labels[i], "name": self.names[i]}


def test_pseudo_labels_never_read_unseen_gt_values(model, tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (65, 65, 3), dtype=np.uint8)
    gt_a = np.zeros((65, 65), np.uint8)
    gt_a[5:25, 5:25] = 2
    gt_a[35:60, 30:60] = 4
    gt_a[0:5, 40:64] = 1
    gt_b = gt_a.copy()
    gt_b[gt_a == 2] = 4
    gt_b[gt_a == 4] = 2  # the unseen ids swapped; tags {2, 4} unchanged
    out_a, out_b = str(tmp_path / "a"), str(tmp_path / "b")
    assert generate_pseudo_labels(model, _StubDataset([img], [gt_a], 6), (2, 4), out_a,
                                  size=65) == 1
    assert generate_pseudo_labels(model, _StubDataset([img], [gt_b], 6), (2, 4), out_b,
                                  size=65) == 1
    pa = np.asarray(Image.open(os.path.join(out_a, "img_000.png")))
    pb = np.asarray(Image.open(os.path.join(out_b, "img_000.png")))
    np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(pa[gt_a == 1], gt_a[gt_a == 1])


def test_pseudo_labels_confidence_threshold(model, tmp_path):
    ds = SyntheticSegmentation(4, (65, 65), num_classes=6, seed=3)
    out_dir = str(tmp_path / "pseudo_conf")
    assert generate_pseudo_labels(model, ds, (2,), out_dir, size=65, confidence=2.0) > 0
    all_dir = str(tmp_path / "pseudo_all")
    generate_pseudo_labels(model, ds, (2,), all_dir, size=65, confidence=1e-9)
    for i in range(4):
        sample = ds[i]
        path = os.path.join(out_dir, sample["name"] + ".png")
        if not os.path.exists(path):
            continue
        pseudo = np.asarray(Image.open(path))
        gt = sample["label"]
        assert np.all(pseudo[gt == 2] == 255)
        np.testing.assert_array_equal(pseudo[gt != 2], gt[gt != 2])
        labelled = np.asarray(Image.open(os.path.join(all_dir, sample["name"] + ".png")))
        assert not np.any(labelled[gt == 2] == 255)


def test_pseudo_label_step_restricts_in_f32():
    """Disallowed classes never win, also from a bf16 model: the logits
    are cast to f32 before finfo(float32).min fills them (in bf16 it is
    -inf, and K1 would multiply a zero tap weight by it)."""
    torch.manual_seed(0)
    model = DeepLab(backbone="resnet50", num_classes=6, dropout=False, dtype=torch.bfloat16)
    init_deeplab(model, 2).eval()
    image = torch.randn(1, 33, 33, 3)
    allowed = torch.tensor([True, False, True, False, False, True])
    for confidence in (0.0, 0.5):
        pred, conf = make_pseudo_label_step(confidence)(model, image, allowed)
        assert pred.dtype == torch.int32 and pred.shape == (1, 33, 33)
        assert torch.isin(pred, torch.tensor([0, 2, 5])).all()
        if confidence:
            assert conf.dtype == torch.float32 and bool(((conf > 0) & (conf <= 1)).all())


def test_weak_label_dataset_override(tmp_path):
    ds = SyntheticSegmentation(4, (33, 33), num_classes=4, seed=0)
    weak_dir = tmp_path / "weak"
    weak_dir.mkdir()
    fake = np.full((33, 33), 3, np.uint8)
    Image.fromarray(fake).save(weak_dir / (ds.names[1] + ".png"))
    wrapped = WeakLabelDataset(ds, str(weak_dir))
    assert len(wrapped) == 4 and wrapped.NUM_CLASSES == 4 and wrapped.names == ds.names
    np.testing.assert_array_equal(wrapped[1]["label"], fake)
    np.testing.assert_array_equal(wrapped[0]["label"], ds[0]["label"])


def test_gt_view_undoes_weak_label_override(tmp_path):
    ds = SyntheticSegmentation(4, (16, 16), num_classes=4, seed=1)
    pseudo_dir = str(tmp_path / "pseudo")
    os.makedirs(pseudo_dir)
    for i in range(4):
        Image.fromarray(np.full((16, 16), 3, np.uint8)).save(
            os.path.join(pseudo_dir, ds[i]["name"] + ".png"))
    wrapped = WeakLabelDataset(ds, pseudo_dir)
    assert (wrapped[0]["label"] == 3).all()
    np.testing.assert_array_equal(_gt_view(wrapped)[0]["label"], ds[0]["label"])

    class FakeVOC:
        weak_label_dir = pseudo_dir
        names = ["a"]

        def __getitem__(self, i):
            return {"label": "weak" if self.weak_label_dir else "gt"}

    v = FakeVOC()
    assert _gt_view(v)[0]["label"] == "gt"
    assert v.weak_label_dir == pseudo_dir

    class FakeUnion:
        def __init__(self, sub):
            self._items = [(sub, 0)]

        def __getitem__(self, i):
            sub, j = self._items[i]
            return sub[j]

    assert _gt_view(FakeUnion(FakeVOC()))[0]["label"] == "gt"


@pytest.mark.parametrize("confidence", [0.0, 0.3])
def test_generate_pseudo_labels_matches_jax(confidence, tmp_path):
    jmodel = JaxDeepLab(backbone="resnet50", num_classes=6, dropout=False, dtype=jnp.float32)
    variables = randomize_bn(jmodel.init(jax.random.key(0), jnp.zeros((1, 65, 65, 3))), seed=4)
    model = DeepLab(backbone="resnet50", num_classes=6, dropout=False)
    model.load_state_dict(state_dict_from_flax(variables))
    model.eval()
    # Non-square images: the letterbox pads, and PNGs return at native size.
    jds = JaxSynthetic(6, (49, 65), num_classes=6, seed=3)
    ds = SyntheticSegmentation(6, (49, 65), num_classes=6, seed=3)
    want_dir, got_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    n = jax_st.generate_pseudo_labels(jmodel, variables, jds, (2, 4), want_dir, size=65,
                                      confidence=confidence)
    assert generate_pseudo_labels(model, ds, (2, 4), got_dir, size=65,
                                  confidence=confidence) == n > 0
    assert sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir))
    differ = total = ignored = 0
    for name in os.listdir(want_dir):
        want = np.asarray(Image.open(os.path.join(want_dir, name)))
        got = np.asarray(Image.open(os.path.join(got_dir, name)))
        assert got.shape == want.shape == (49, 65)
        differ += int((got != want).sum())
        total += want.size
        ignored += int((want == 255).sum())
    assert differ <= 0.001 * total, f"{differ} of {total} pixels differ"
    if confidence:
        assert ignored > 0


def test_cli_train_zs5_on_cpu(tmp_path, capsys):
    ck = ["--checkpoint-dir", str(tmp_path), "--checkname", "z", *small_config(tmp_path)]
    with pytest.warns(UserWarning, match="randomly initialised"):
        assert cli.main(["train-zs5", *TINY, *ck]) == 0
    captured = capsys.readouterr()
    out = captured.out.strip().splitlines()[-1]
    assert "harmonic_miou" in out and "mmd" in out
    written = int(re.search(r"pseudo-labeled (\d+) images", captured.err).group(1))
    assert written > 0 and len(os.listdir(tmp_path / "pseudo_labels")) == written
    exp = Saver.latest_experiment(str(tmp_path), "synthetic", "z-zs5")
    assert exp is not None and Saver.latest_checkpoint(exp) is not None
    assert Saver.latest_experiment(str(tmp_path), "synthetic", "z-gmmn") is None


def test_cli_auto_resume_never_crosses_stages(tmp_path):
    ck = ["--checkpoint-dir", str(tmp_path), "--checkname", "s", "--auto-resume",
          *small_config(tmp_path)]
    with pytest.warns(UserWarning, match="randomly initialised"):
        _, zs3 = cli.run(["train-gmmn", *TINY, *ck, "--no-val"])
    assert zs3.global_step == 2
    with pytest.warns(UserWarning, match="randomly initialised"):
        _, zs5 = cli.run(["train-zs5", *TINY, *ck, "--no-val"])
    assert isinstance(zs5, ZS5Trainer) and not zs5.cfg.train.gmmn_resume
    assert zs5.global_step == 2 and "-zs5" in zs5.saver.directory
    with pytest.warns(UserWarning, match="randomly initialised"):
        _, again = cli.run(["train-zs5", *TINY, *ck, "--no-val"])
    assert "-zs5" in again.cfg.train.gmmn_resume and again.global_step == 4
    with pytest.warns(UserWarning, match="randomly initialised"):
        _, ev = cli.run(["evaluate-gmmn", *EVAL_TINY, *ck])
    assert "-gmmn" in ev.cfg.train.gmmn_resume and ev.global_step == 2


def test_no_message_cites_a_queue_item_number():
    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "zs3_tpu_torch")
    pattern = re.compile(r"Queue 1 items? [0-9]")
    hits = []
    for base, _, files in os.walk(root):
        for name in files:
            if name.endswith((".py", ".cu")):
                path = os.path.join(base, name)
                with open(path) as f:
                    hits += [f"{path}:{i}" for i, line in enumerate(f, 1) if pattern.search(line)]
    assert not hits, hits


@pytest.mark.slow
def test_zs5_trainer_end_to_end(tmp_path):
    cfg = Config(
        model=ModelConfig(backbone="resnet50", num_classes=6, compute_dtype="float32",
                          dropout=False),
        gmmn=GMMNConfig(embed_dim=32, noise_dim=16, hidden_dim=32, pixels_per_class=32),
        data=DataConfig(dataset="synthetic", crop_size=65, base_size=65, batch_size=8,
                        eval_batch_size=8, unseen_classes=(2,), synthetic_classes=6),
        train=TrainConfig(epochs=1, steps_per_epoch=2, checkpoint_dir=str(tmp_path / "run"),
                          keep_checkpoints=1),
    )
    with pytest.warns(UserWarning, match="randomly initialised"):
        trainer = ZS5Trainer(cfg, device="cpu")
    assert trainer.cfg.gmmn.self_training
    n = trainer.pseudo_label()
    assert n > 0 and len(os.listdir(trainer.pseudo_dir)) == n
    stats = trainer.train_epoch(0)
    assert np.isfinite(stats["mmd"]) and np.isfinite(stats["cls_ce"])
    report = trainer.validate(0)
    assert "harmonic_miou" in report
