"""ZS5Net self-training: pseudo-label unseen pixels, then retrain
(port of zs3_tpu.train.self_training).

  1. `generate_pseudo_labels` runs the current network (trunk + retrained
     classifier) over each train image whose tags name an unseen class,
     letterboxed onto the crop size, with the prediction restricted to
     (seen classes + the image's unseen tags), and writes PNG
     pseudo-labels at native resolution;
  2. `ZS5Trainer` re-runs the GMMNTrainer with the train set's labels read
     from that directory (no unseen-image filtering) and
     gmmn.self_training=True, so real features at pseudo-labelled pixels
     reach the classifier CE and the MMD targets.

What stage 1 reads of the annotation (the weak supervision ZS5 assumes):
the image, the seen-GT view (GT where it is a seen class or ignore;
pixels annotated with an unseen class are unlabelled and their class ids
are never read) and the image-level unseen tag set.

The restricted logits are f32: the model's `classify` output is cast
before `finfo(float32).min` fills the disallowed classes, since that value
is -inf in bf16 and K1 multiplies zero tap weights by it.  Without a
confidence threshold the labels come from `predict_labels` (kernel K1 on
the GPU, its plain version on the CPU); with one, from a plain resize,
argmax and softmax, as in zs3_tpu.  Under `train.int8_features` the
labelling forward runs int8, with the trunk scales of the ZS3 step.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from PIL import Image

from zs3_tpu_torch import quant
from zs3_tpu_torch.core.config import Config
from zs3_tpu_torch.data.transforms import letterbox_image, normalize, unletterbox_pred
from zs3_tpu_torch.models.deeplab import DeepLab
from zs3_tpu_torch.ops.eval_kernels import predict_labels
from zs3_tpu_torch.ops.resize import resize_bilinear
from zs3_tpu_torch.train.gmmn import GMMNTrainer, splice_classifier
from zs3_tpu_torch.utils.saver import Saver

PseudoStep = Callable[[DeepLab, torch.Tensor, torch.Tensor],
                      Tuple[torch.Tensor, Optional[torch.Tensor]]]


def make_pseudo_label_step(confidence: float = 0.0) -> PseudoStep:
    """step(model, image (1, S, S, 3), allowed (C,) bool) -> ((1, S, S)
    int32 labels, (1, S, S) max softmax probability or None)."""

    def restricted_logits(model: DeepLab, image: torch.Tensor, allowed: torch.Tensor):
        """(1, s, s, C) f32 logits at the feature grid, finfo.min where a
        class is not allowed.  Masking channels commutes with the
        (channelwise, convex) bilinear upsample, so it applies before it."""
        logits = model.classify(model.forward_features(image)).float()
        return torch.where(allowed, logits, torch.finfo(torch.float32).min)

    @torch.inference_mode()
    def step(model: DeepLab, image: torch.Tensor, allowed: torch.Tensor):
        restricted = restricted_logits(model, image, allowed)
        size = tuple(image.shape[1:3])
        if confidence <= 0.0:
            return predict_labels(restricted, size), None
        # Softmax needs every class at full resolution, so the threshold
        # path materialises the upsampled logits instead of using K1.
        up = resize_bilinear(restricted, size, True)
        return up.argmax(-1).to(torch.int32), torch.softmax(up, -1).amax(-1)

    return step


def generate_pseudo_labels(
    model: DeepLab,
    dataset,
    unseen_classes: Sequence[int],
    out_dir: str,
    size: int = 513,
    ignore_index: int = 255,
    confidence: float = 0.0,
) -> int:
    """Write a pseudo-label PNG for every image of `dataset` whose tag set
    holds an unseen class; returns the number written.

    Runs `model` where it lies (it is moved nowhere).  Labelled pixels
    (a seen class or ignore) keep their GT; unlabelled ones take the
    model's argmax restricted to (seen + the image's tags), or
    `ignore_index` where its max softmax probability is below
    `confidence`."""
    os.makedirs(out_dir, exist_ok=True)
    unseen = np.asarray(sorted(unseen_classes), dtype=np.int64)
    num_classes = dataset.NUM_CLASSES
    device = next(model.parameters()).device
    step = make_pseudo_label_step(confidence)
    model.eval()
    written = 0
    for i in range(len(dataset)):
        sample = dataset[i]
        gt = np.asarray(sample["label"])
        # Image-level tags: the unseen classes the annotator flagged.
        tags = np.intersect1d(np.unique(gt), unseen)
        if tags.size == 0:
            continue
        # Seen-GT view: True where the annotation labels the pixel.
        labeled = ~np.isin(gt, unseen)
        canvas, content = letterbox_image(sample["image"], size)
        image = normalize({"image": canvas, "label": np.zeros((size, size), np.uint8)})["image"]
        allowed = np.ones(num_classes, dtype=bool)
        allowed[unseen] = False
        allowed[tags] = True
        pred, conf = step(model, torch.from_numpy(image)[None].to(device),
                          torch.from_numpy(allowed).to(device))
        ch, cw = content
        pred_full = unletterbox_pred(pred[0].cpu().numpy(), content, gt.shape[:2]).astype(np.int64)
        if conf is not None:
            conf_img = Image.fromarray(
                conf[0].float().cpu().numpy()[:ch, :cw], mode="F"
            ).resize((gt.shape[1], gt.shape[0]), Image.NEAREST)
            pred_full = np.where(np.asarray(conf_img) < confidence, ignore_index, pred_full)
        pseudo = np.where(labeled, gt, pred_full).astype(np.uint8)
        Image.fromarray(pseudo, mode="L").save(os.path.join(out_dir, sample["name"] + ".png"))
        written += 1
    return written


class WeakLabelDataset:
    """Any dataset with its labels read from a pseudo-label directory
    where a PNG of the sample's name exists (synthetic data has no weak
    label hook of its own)."""

    def __init__(self, dataset, weak_label_dir: str):
        self.dataset = dataset
        self.weak_label_dir = weak_label_dir
        self.NUM_CLASSES = dataset.NUM_CLASSES
        self.names = dataset.names

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx: int):
        sample = self.dataset[idx]
        path = os.path.join(self.weak_label_dir, sample["name"] + ".png")
        if os.path.exists(path):
            sample = {**sample, "label": np.asarray(Image.open(path))}
        return sample


def _gt_view(dataset):
    """`dataset` serving its real (weak) annotation: any weak-label
    override undone, through wrappers and unions.  Pseudo-labelling must
    never read an earlier run's PNGs as ground truth."""
    if isinstance(dataset, WeakLabelDataset):
        return _gt_view(dataset.dataset)
    if getattr(dataset, "weak_label_dir", None):
        ds = copy.copy(dataset)
        ds.weak_label_dir = None
        return ds
    if hasattr(dataset, "_items"):  # a union: clean each sub-dataset once
        ds = copy.copy(dataset)
        cleaned: dict = {}
        ds._items = [(cleaned.setdefault(id(sub), _gt_view(sub)), i) for sub, i in dataset._items]
        return ds
    return dataset


class ZS5Trainer(GMMNTrainer):
    """Stage A: pseudo-label with the current network; stage B: the GMMN
    and classifier retraining over the augmented label set."""

    # Not GMMNTrainer's "-gmmn": the two stages' states have the same
    # shapes, so --auto-resume across them would restore silently.
    checkpoint_suffix = "-zs5"

    def __init__(self, cfg: Config, device: Union[str, torch.device] = "cuda",
                 saver: Optional[Saver] = None, pseudo_label_dir: Optional[str] = None):
        pseudo_dir = pseudo_label_dir or os.path.join(cfg.train.checkpoint_dir, "pseudo_labels")
        cfg = cfg.replace(
            # A weak-label dir keeps the unseen images in the train set.
            data=dataclasses.replace(cfg.data, weak_label_dir=pseudo_dir),
            # Real features at pseudo-labelled unseen pixels train both
            # updates (mmd_training_masks, classifier_training_set).
            gmmn=dataclasses.replace(cfg.gmmn, self_training=True),
        )
        super().__init__(cfg, device=device, saver=saver)
        self.pseudo_dir = pseudo_dir
        if cfg.data.dataset == "synthetic":  # VOC and Context readers read weak labels
            self.train_loader.dataset = WeakLabelDataset(self.train_loader.dataset, pseudo_dir)

    def pseudo_label(self) -> int:
        """Stage A with the trunk and the current classifier over the
        train set's real annotation; returns the PNGs written."""
        # splice_classifier writes into self.model in place; the step's
        # features() stops before the classifier, so it reads nothing of it.
        model = splice_classifier(self.model, self.step.cls)
        # Under int8_features the labelling forward runs int8 too (the
        # retrained classifier stays float by the exclusion rule).
        int8 = (quant.quantized(self.trunk_int8_scales()) if self.cfg.train.int8_features
                else contextlib.nullcontext())
        with int8:
            return generate_pseudo_labels(
                model, _gt_view(self.train_loader.dataset), self.unseen, self.pseudo_dir,
                size=self.cfg.data.crop_size, ignore_index=self.cfg.data.ignore_index,
                confidence=self.cfg.gmmn.pseudo_confidence,
            )
