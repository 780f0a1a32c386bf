"""Metric logging (port of zs3_tpu.utils.logging): an append-only
``metrics.jsonl`` per experiment, and TensorBoard scalars and image
panels through torch.utils.tensorboard when it imports (when it does
not, there is no writer, as zs3_tpu has none without tensorflow)."""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np


class MetricLogger:
    def __init__(self, directory: str, tensorboard: bool = False):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, "metrics.jsonl")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(os.path.join(directory, "tb"))

    def log(self, step: int, scalars: Dict[str, float], prefix: str = ""):
        record = {
            "step": int(step),
            "time": time.time(),
            **{
                (f"{prefix}/{k}" if prefix else k): float(v)
                for k, v in scalars.items()
                if np.isscalar(v) or isinstance(v, (int, float, np.floating))
            },
        }
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self._tb is not None:
            for k, v in record.items():
                if k not in ("step", "time"):
                    self._tb.add_scalar(k, v, step)
            self._tb.flush()

    def log_images(self, step: int, images: Dict[str, np.ndarray]):
        """images: name -> (H, W, 3) uint8; TensorBoard only."""
        if self._tb is not None:
            for name, img in images.items():
                self._tb.add_image(name, img, step, dataformats="HWC")
            self._tb.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
