"""Offline inference: image files -> segmentation PNGs
(port of zs3_tpu.train.predict).

Load a seeded init or a `.pt` state_dict, run images through the
fixed-size forward, resize predictions back to native resolution, write
raw label PNGs and colorized panels.  uint8 images go to the device and
are normalized there; labels are the first maximum of the forward's f32
logits, as jnp.argmax takes it.  With `model.fused_tail` the forward's
classify+upsample runs on kernel K4 on the GPU.  Entry points run on the
GPU unless `device="cpu"` is given.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, List, Optional, Tuple, Union

import numpy as np
import torch
from PIL import Image

from zs3_tpu_torch.core.config import Config
from zs3_tpu_torch.core.device import resolve_device
from zs3_tpu_torch.data.transforms import (
    IMAGENET_MEAN,
    batched_normalize_device,
    letterbox_image,
    unletterbox_pred,
)
from zs3_tpu_torch.train.seen import build_eval_model
from zs3_tpu_torch.utils.viz import decode_segmap


def sliding_windows(
    hw: Tuple[int, int], crop: int, overlap: float = 1 / 3
) -> List[Tuple[int, int]]:
    """(y, x) offsets of the crop-size windows predict_sliding runs over an
    image of size `hw` (padded up to `crop` first): every stride along
    each axis, plus a final window aligned to the edge."""
    stride = max(int(round(crop * (1 - overlap))), 1)

    def starts(extent):
        ss = list(range(0, max(extent - crop, 0) + 1, stride))
        if ss[-1] != extent - crop:
            ss.append(extent - crop)
        return ss

    return [(y, x) for y in starts(max(hw[0], crop)) for x in starts(max(hw[1], crop))]


class Predictor:
    def __init__(
        self,
        cfg: Config,
        checkpoint: Optional[str] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        self.device = resolve_device(device)
        if checkpoint:
            cfg = cfg.replace(train=dataclasses.replace(cfg.train, resume=checkpoint))
        self.cfg = cfg
        self.model = build_eval_model(cfg, self.device)

    def quantize(self, calib_images: Iterable[np.ndarray], *args, **kwargs) -> int:
        raise NotImplementedError(
            "int8 PTQ inference is not ported yet: ROADMAP Queue 1 item 10"
        )

    @torch.inference_mode()
    def _logits(self, images: np.ndarray) -> torch.Tensor:
        """(N, S, S, 3) uint8 -> (N, S, S, K) f32 logits on the device."""
        x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        return self.model(batched_normalize_device(x)).float()

    @torch.inference_mode()
    def _predict(self, images: np.ndarray) -> np.ndarray:
        """(N, S, S, 3) uint8 -> (N, S, S) int32 labels on the host."""
        labels = self._logits(images).argmax(dim=-1).to(torch.int32)
        return labels.cpu().numpy()

    def predict_array(self, image: np.ndarray) -> np.ndarray:
        """HWC uint8 image -> HW int32 label map at native resolution.

        Geometry: aspect-preserving letterbox onto the fixed input
        (ImageNet-mean padding normalizes to zero), prediction cropped to
        the content region and resized back — no aspect squash.
        """
        h, w = image.shape[:2]
        canvas, content = letterbox_image(image, self.cfg.data.crop_size)
        pred = self._predict(canvas[None])[0]
        return unletterbox_pred(pred, content, (h, w))

    def predict_batch(self, images: "list[np.ndarray]") -> "list[np.ndarray]":
        """Batched inference: one device round trip for many images, each
        letterboxed to the fixed input and returned at its native size."""
        size = self.cfg.data.crop_size
        stacked, contents = [], []
        for image in images:
            canvas, content = letterbox_image(image, size)
            contents.append(content)
            stacked.append(canvas)
        preds = self._predict(np.stack(stacked))
        return [
            unletterbox_pred(pred, content, image.shape[:2])
            for image, content, pred in zip(images, contents, preds)
        ]

    @torch.inference_mode()
    def predict_sliding(
        self,
        image: np.ndarray,
        overlap: float = 1 / 3,
        window_batch: int = 8,
    ) -> np.ndarray:
        """Native-resolution prediction by sliding crop-size windows.

        Tiles the image with `overlap` fraction of window overlap
        (edge-aligned final rows/columns), averages softmax probabilities
        where windows overlap (on the device), and argmaxes at full
        resolution.  Windows run in fixed batches of `window_batch`, the
        last one padded with copies of its first window.
        """
        crop = self.cfg.data.crop_size
        h, w = image.shape[:2]
        # pad small images up to the window size (ImageNet-mean pixels
        # become zeros after normalization)
        ph, pw = max(crop - h, 0), max(crop - w, 0)
        if ph or pw:
            canvas = np.empty((h + ph, w + pw, 3), image.dtype)
            canvas[:] = (np.array(IMAGENET_MEAN) * 255).astype(image.dtype)
            canvas[:h, :w] = image
            image = canvas
        hp, wp = image.shape[:2]
        wins = sliding_windows((h, w), crop, overlap)
        num_classes = self.cfg.model.num_classes
        probs = torch.zeros((hp, wp, num_classes), dtype=torch.float32, device=self.device)
        count = torch.zeros((hp, wp, 1), dtype=torch.float32, device=self.device)
        for i in range(0, len(wins), window_batch):
            chunk = wins[i : i + window_batch]
            tiles = np.stack([image[y : y + crop, x : x + crop] for (y, x) in chunk])
            n_real = len(chunk)
            if n_real < window_batch:  # keep the batch shape fixed
                tiles = np.concatenate(
                    [tiles, np.repeat(tiles[:1], window_batch - n_real, 0)]
                )
            p = torch.softmax(self._logits(tiles)[:n_real], dim=-1)
            for (y, x), pw_ in zip(chunk, p):
                probs[y : y + crop, x : x + crop] += pw_
                count[y : y + crop, x : x + crop] += 1.0
        pred = (probs / count.clamp(min=1.0)).argmax(dim=-1)
        return pred[:h, :w].to(torch.int32).cpu().numpy()

    def predict_files(
        self,
        paths: Iterable[str],
        out_dir: str,
        colorize: bool = True,
        batch_size: int = 8,
        sliding: bool = False,
    ) -> List[str]:
        os.makedirs(out_dir, exist_ok=True)
        paths = list(paths)
        written = []
        for start in range(0, len(paths), batch_size):
            chunk = paths[start : start + batch_size]
            images = [np.asarray(Image.open(p).convert("RGB")) for p in chunk]
            n_real = len(images)
            if sliding:
                preds = [self.predict_sliding(img) for img in images]
            else:
                # pad the final chunk so every forward sees one batch shape
                while len(images) < batch_size:
                    images.append(images[0])
                preds = self.predict_batch(images)[:n_real]
            for path, pred in zip(chunk, preds):
                stem = os.path.splitext(os.path.basename(path))[0]
                raw = os.path.join(out_dir, stem + ".png")
                Image.fromarray(pred.astype(np.uint8), mode="L").save(raw)
                written.append(raw)
                if colorize:
                    color = decode_segmap(pred, self.cfg.model.num_classes)
                    color_path = os.path.join(out_dir, stem + "_color.png")
                    Image.fromarray(color).save(color_path)
                    written.append(color_path)
        return written
