"""Serialized model export for deployment through torch.export (port of
zs3_tpu.export).

Exports the inference path: uint8 NHWC images in, int32 label maps (or
f32 logits) out, normalization and trained weights baked into the
program.  The artifact is a `torch.export` archive (`.pt2`):

  * `load_exported` runs it through `torch.export.load(path).module()`
    alone: no zs3_tpu_torch import, no config, no checkpoint;
  * it holds one device's weights.  `platforms` names that device type
    (`cuda` or `cpu`), and the export runs there; `load_exported(path,
    device)` moves a program to another device at load time (zs3_tpu
    lowers one artifact for several platforms instead).

The upsample and argmax are the portable resize of ops/resize.py and a
plain argmax, as zs3_tpu exports them: the port's kernels K1 and K4 are
ctypes launches that no trace can follow, so the exported model is built
with `fused_tail=False` and `export --fused-tail` is refused.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from zs3_tpu_torch import quant
from zs3_tpu_torch.core.config import Config
from zs3_tpu_torch.core.device import resolve_device
from zs3_tpu_torch.data.transforms import batched_normalize_device

EMITS = ("labels", "logits")


class InferenceModule(torch.nn.Module):
    """uint8 NHWC batch -> int32 labels (or f32 logits) of `model`: the
    module torch.export traces (zs3_tpu's `infer`)."""

    def __init__(self, model: torch.nn.Module, emit: str,
                 int8_scales: Optional[quant.Scales]):
        super().__init__()
        self.model = model
        self.emit = emit
        self.int8_scales = int8_scales

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = batched_normalize_device(images)
        logits = quant.under(self.int8_scales, self.model)(x).float()
        if self.emit == "logits":
            return logits
        return logits.argmax(dim=-1).to(torch.int32)


def make_inference_fn(
    model: torch.nn.Module, emit: str = "labels",
    int8_scales: Optional[quant.Scales] = None,
) -> InferenceModule:
    """Self-contained inference of an eval-mode `model`: uint8 NHWC batch
    -> labels or logits.  With `int8_scales` (quant.calibrate's) every
    eligible conv runs int8, so a trace of it is an int8 program."""
    if emit not in EMITS:
        raise ValueError(f"emit must be 'labels' or 'logits', got {emit!r}")
    return InferenceModule(model, emit, int8_scales or None)


def _checkpoint_keys(path: str) -> set:
    """Top-level keys of a torch.save checkpoint (memory-mapped: no copy
    of its tensors)."""
    payload = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    return set(payload) if isinstance(payload, dict) else set()


def restore_retrained_classifier(path: str, num_classes: int) -> Dict[str, torch.Tensor]:
    """The retrained (D, C) classifier {"kernel", "bias"} of a GMMN- or
    ZS5-stage checkpoint (the {"gen", "cls", ...} payload GMMNTrainer
    writes)."""
    from zs3_tpu_torch.utils.saver import Saver

    keys = _checkpoint_keys(path)
    if "cls" not in keys:
        raise ValueError(
            f"{path!r} is not a GMMN-stage checkpoint (top-level keys "
            f"{sorted(keys)[:8]}, expected 'gen'/'cls'); pass the seen-stage "
            "trunk via --resume and a train-gmmn/train-zs5 checkpoint via --gmmn-resume"
        )
    cls = Saver.restore(path)["cls"]
    if cls["kernel"].shape[-1] != num_classes:
        raise ValueError(
            f"retrained classifier in {path!r} has {cls['kernel'].shape[-1]} classes, "
            f"config says {num_classes}"
        )
    return {"kernel": cls["kernel"], "bias": cls["bias"]}


def export_device(platforms: Optional[Sequence[str]],
                  device: Union[str, torch.device]) -> torch.device:
    """The device an export runs on: the one device type `platforms`
    names, else `device`.  Two platforms are refused: an exported program
    holds one device's weights (load_exported moves it)."""
    if platforms:
        platforms = [p.strip() for p in platforms if p.strip()]
        if len(platforms) != 1:
            raise ValueError(
                f"--platforms {','.join(platforms)}: a torch.export artifact holds one "
                "device's weights; export once per device type (cuda or cpu), or "
                "move an artifact at load time (load_exported(path, device))")
        if platforms[0] not in ("cuda", "cpu"):
            raise ValueError(f"--platforms {platforms[0]!r}: the port exports for "
                             "'cuda' or 'cpu'")
        device = platforms[0]
    return resolve_device(device)


def export_predictor(
    cfg: Config,
    checkpoint: Optional[str] = None,
    gmmn_checkpoint: Optional[str] = None,
    batch_size: int = 1,
    emit: str = "labels",
    platforms: Optional[Sequence[str]] = None,
    allow_random: bool = False,
    int8_calib_images: Optional[Sequence[np.ndarray]] = None,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[torch.export.ExportedProgram, dict]:
    """Export the (checkpoint-restored) inference path with torch.export.

    `checkpoint` (or cfg.train.resume) restores the seen-stage trunk;
    `gmmn_checkpoint` (or cfg.train.gmmn_resume) splices the retrained
    zero-shot classifier of a train-gmmn/train-zs5 checkpoint, as
    evaluate-gmmn serves it.  `int8_calib_images` (uint8 HWC, any sizes)
    calibrates int8 scales on their letterboxed canvases, one batch, and
    bakes int8 convs into the program.  Returns (the ExportedProgram, its
    manifest)."""
    from zs3_tpu_torch.train.gmmn import splice_classifier
    from zs3_tpu_torch.train.predict import Predictor

    if emit not in EMITS:
        raise ValueError(f"emit must be 'labels' or 'logits', got {emit!r}")
    if cfg.model.fused_tail:
        raise ValueError(
            "export --fused-tail: the fused tail is kernel K4, a ctypes launch that "
            "torch.export cannot trace; the artifact runs the portable resize and "
            "argmax, as zs3_tpu's does (ROADMAP Queue 3, stated divergences)")
    device = export_device(platforms, device)
    ckpt = checkpoint or cfg.train.resume
    gmmn_ckpt = gmmn_checkpoint or cfg.train.gmmn_resume
    if ckpt:
        if {"gen", "cls"} <= _checkpoint_keys(ckpt):
            raise ValueError(
                f"--resume {ckpt!r} is a GMMN-stage checkpoint (gen/cls payload, no "
                "trunk weights); pass the seen-stage checkpoint via --resume and this "
                "one via --gmmn-resume to export the zero-shot model")
    elif not allow_random:
        # A forgotten --resume would export randomly initialised weights
        # into a valid-looking artifact that serves garbage.
        raise ValueError(
            "export without a checkpoint would serialize randomly initialized "
            "weights; pass --resume <ckpt> (or allow_random=True / --allow-random "
            "for a smoke artifact)")
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, fused_tail=False),
        train=dataclasses.replace(cfg.train, resume=ckpt or None),
    )
    predictor = Predictor(cfg, device=device)
    model = predictor.model
    if gmmn_ckpt:
        cls_params = restore_retrained_classifier(gmmn_ckpt, cfg.model.num_classes)
        splice_classifier(model, {k: v.to(device) for k, v in cls_params.items()})
    size = cfg.data.crop_size
    int8_scales = None
    if int8_calib_images is not None:
        from zs3_tpu_torch.data.transforms import letterbox_image

        canvases = np.stack([letterbox_image(np.asarray(img), size)[0]
                             for img in int8_calib_images])
        int8_scales = quant.calibrate(
            model, [torch.from_numpy(canvases).to(device)], forward=predictor._forward,
            percentile=cfg.train.int8_percentile)
    for p in model.parameters():
        p.requires_grad_(False)
    infer = make_inference_fn(model, emit, int8_scales).eval()
    example = torch.zeros((batch_size, size, size, 3), dtype=torch.uint8, device=device)
    with torch.no_grad():
        program = torch.export.export(infer, (example,))
    manifest = {
        "input": f"uint8[{batch_size},{size},{size},3] NHWC",
        "output": (
            f"int32[{batch_size},{size},{size}] labels"
            if emit == "labels"
            else f"float32[{batch_size},{size},{size},{cfg.model.num_classes}] logits"
        ),
        "platforms": [device.type],
        "backbone": cfg.model.backbone,
        "num_classes": cfg.model.num_classes,
        "batch_size": batch_size,
        "crop_size": size,
        "emit": emit,
        "zero_shot_classifier": bool(gmmn_ckpt),
        # bool(): an empty calibration result traces float, labelled float.
        "int8": bool(int8_scales),
    }
    return program, manifest


def save_exported(path: str, program: torch.export.ExportedProgram, manifest: dict) -> int:
    """Write `<path>` (torch.export.save) and `<path>.json` (the
    manifest); returns the artifact's size in bytes."""
    import os

    torch.export.save(program, path)
    with open(path + ".json", "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    return os.path.getsize(path)


def load_exported(
    path: str, device: Union[str, torch.device, None] = None
) -> Callable[[Union[np.ndarray, torch.Tensor]], Union[np.ndarray, torch.Tensor]]:
    """The artifact at `path` as a callable on uint8 NHWC batches (numpy
    in, numpy out; a tensor in, a tensor out on the program's device).
    Only torch.export.load(...).module() runs it: no model code, config
    or checkpoint.  With a `device` other than the artifact's, the program
    is moved there first."""
    program = torch.export.load(path)
    module = program.module()
    target = next(itertools.chain(module.parameters(), module.buffers())).device
    if device is not None and torch.device(device) != target:
        from torch.export.passes import move_to_device_pass

        module = move_to_device_pass(program, torch.device(device)).module()
        target = next(itertools.chain(module.parameters(), module.buffers())).device

    def call(images):
        host = isinstance(images, np.ndarray)
        x = torch.from_numpy(np.require(images, requirements="CW")) if host else images
        x = x.to(target)
        with torch.no_grad():
            out = module(x)
        return out.cpu().numpy() if host else out

    return call
