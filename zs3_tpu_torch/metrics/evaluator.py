"""Segmentation metrics with seen/unseen/harmonic splits.

Port of zs3_tpu.metrics.evaluator: Pixel_Accuracy, Pixel_Accuracy_Class,
MIoU and FWIoU of the reference, plus the ZS3 split of per-class IoU into
seen-mIoU, unseen-mIoU and harmonic hIoU = 2su/(s+u).  The confusion
matrix stays on the device as int64 counts; only the final (C, C) matrix
is copied to the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from zs3_tpu_torch.ops.confusion import confusion_matrix


def iou_from_confusion(conf: np.ndarray) -> np.ndarray:
    """Per-class IoU; NaN for classes absent from both gt and pred."""
    conf = np.asarray(conf, dtype=np.float64)
    tp = np.diag(conf)
    denom = conf.sum(axis=1) + conf.sum(axis=0) - tp
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(denom > 0, tp / denom, np.nan)


@dataclass
class MetricReport:
    pixel_accuracy: float
    pixel_accuracy_class: float
    miou: float
    fwiou: float
    per_class_iou: np.ndarray
    seen_miou: Optional[float] = None
    unseen_miou: Optional[float] = None
    harmonic_miou: Optional[float] = None

    def as_dict(self) -> Dict[str, float]:
        out = {
            "pixel_accuracy": self.pixel_accuracy,
            "pixel_accuracy_class": self.pixel_accuracy_class,
            "miou": self.miou,
            "fwiou": self.fwiou,
        }
        if self.seen_miou is not None:
            out.update(
                seen_miou=self.seen_miou,
                unseen_miou=self.unseen_miou,
                harmonic_miou=self.harmonic_miou,
            )
        return out


class Evaluator:
    """Streaming evaluator; counts accumulate on the device of the first
    batch, compute() runs on the host."""

    def __init__(
        self,
        num_classes: int,
        ignore_index: int = 255,
        unseen_classes: Sequence[int] = (),
    ):
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.unseen_classes = tuple(unseen_classes)
        self.reset()

    def reset(self):
        self._conf: Optional[torch.Tensor] = None

    def add_batch(self, gt: torch.Tensor, pred: torch.Tensor):
        """gt/pred: integer maps of identical shape (stay on device)."""
        self.add_confusion(
            confusion_matrix(gt, pred, self.num_classes, self.ignore_index)
        )

    def add_confusion(self, conf: torch.Tensor):
        """Merge a precomputed (C, C) count matrix (e.g. from an eval step)."""
        conf = conf.long()
        self._conf = conf.clone() if self._conf is None else self._conf + conf

    @property
    def confusion(self) -> np.ndarray:
        if self._conf is None:
            return np.zeros((self.num_classes, self.num_classes), np.int64)
        return self._conf.cpu().numpy()

    def compute(self) -> MetricReport:
        conf = self.confusion.astype(np.float64)
        total = conf.sum()
        tp = np.diag(conf)
        pa = float(tp.sum() / total) if total > 0 else 0.0
        gt_per_class = conf.sum(axis=1)
        with np.errstate(divide="ignore", invalid="ignore"):
            acc_c = np.where(gt_per_class > 0, tp / gt_per_class, np.nan)
        pac = float(np.nanmean(acc_c)) if np.any(gt_per_class > 0) else 0.0
        iou = iou_from_confusion(conf)
        miou = float(np.nanmean(iou)) if np.any(~np.isnan(iou)) else 0.0
        freq = gt_per_class / total if total > 0 else np.zeros_like(gt_per_class)
        fwiou = float(np.nansum(freq * np.nan_to_num(iou)))

        report = MetricReport(pa, pac, miou, fwiou, iou)
        if self.unseen_classes:
            unseen = np.asarray(self.unseen_classes)
            seen = np.setdiff1d(np.arange(self.num_classes), unseen)
            s = float(np.nanmean(iou[seen])) if len(seen) else 0.0
            u = float(np.nanmean(iou[unseen])) if len(unseen) else 0.0
            s = 0.0 if np.isnan(s) else s
            u = 0.0 if np.isnan(u) else u
            h = 2 * s * u / (s + u) if (s + u) > 0 else 0.0
            report.seen_miou, report.unseen_miou, report.harmonic_miou = s, u, h
        return report
