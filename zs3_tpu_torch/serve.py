"""Segmentation inference server, stdlib HTTP only (port of zs3_tpu.serve).

  GET  /healthz            -> {"status": "ok", "warm": true}
  GET  /info               -> model/config summary
  POST /predict            -> raw label map as PNG (mode L)
       ?color=1            -> VOC-palette colorized PNG instead
       ?sliding=1          -> native-resolution sliding-window inference
       body: image file bytes (any PIL-readable format)

Non-square images are letterboxed onto the model's fixed square input
and predictions crop and resize back to native resolution (`?sliding=1`
tiles at native resolution instead).  With `serve_batch` N > 1,
concurrent requests are micro-batched onto one fixed-shape forward of N
images: one worker thread drains whatever is queued (a lone request
never waits for peers) and pads the group to N.  All device work,
batched forwards and `?sliding=1` requests alike, is serialized behind
one lock.  A bad image answers 400, a device failure 500, and an error
in a batched forward reaches every request of its group.  The GPU is
the default device; `device="cpu"` serves from the plain PyTorch path.
With `int8_calib_images` the predictor calibrates int8 scales on those
image files once, at start-up (Predictor.quantize), and serves int8.
With `artifact` it serves an exported labels artifact (zs3_tpu_torch.export)
instead of a checkpoint: its fixed batch and size come from its manifest.
"""

from __future__ import annotations

import collections
import dataclasses
import io
import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Union

import numpy as np
import torch
from PIL import Image

from zs3_tpu_torch.core.config import Config
from zs3_tpu_torch.core.device import resolve_device
from zs3_tpu_torch.data.transforms import letterbox_image, unletterbox_pred
from zs3_tpu_torch.train.predict import Predictor
from zs3_tpu_torch.utils.viz import decode_segmap


class ArtifactPredictor:
    """Predictor-like facade over an exported labels artifact
    (zs3_tpu_torch.export): no model code, config or checkpoint.

    The artifact has a fixed (batch, size) uint8 input with normalization
    baked in; a request is letterboxed onto it as Predictor.predict_array
    does (the ImageNet-mean padding normalizes to zero inside it), sent as
    the whole fixed batch, and its labels cropped and resized back.
    Sliding windows need live logits at any window and are refused.  On a
    `device` other than the artifact's the program is moved there."""

    def __init__(self, artifact_path: str, device: Union[str, torch.device] = "cuda"):
        from zs3_tpu_torch.export import load_exported

        with open(artifact_path + ".json") as f:
            self.manifest = json.load(f)
        if self.manifest.get("emit", "labels") != "labels":
            raise ValueError("serving needs a labels artifact; this one emits "
                             f"{self.manifest.get('emit')!r}")
        self.batch = int(self.manifest["batch_size"])
        self.size = int(self.manifest["crop_size"])
        self.num_classes = int(self.manifest["num_classes"])
        self.device = resolve_device(device)
        self._call = load_exported(artifact_path, self.device)

    def predict_array(self, image: np.ndarray) -> np.ndarray:
        h, w = image.shape[:2]
        canvas, content = letterbox_image(image, self.size)
        batch = np.broadcast_to(canvas, (self.batch, self.size, self.size, 3))
        pred = self._call(batch)[0]
        return unletterbox_pred(pred, content, (h, w))

    def predict_sliding(self, image: np.ndarray) -> np.ndarray:
        raise ValueError(
            "sliding-window inference is not available when serving an exported "
            "artifact (fixed-shape labels graph); serve a checkpoint instead")


class _MicroBatcher:
    """Aggregate concurrent requests into fixed-shape batched forwards.

    A single worker thread blocks for the FIRST request, then greedily
    takes whatever is ALREADY queued up to `max_batch` (no wait window),
    pads the group to `max_batch` and runs one forward.  `groups` counts
    the forwards run; `batch_sizes` keeps the sizes of the last 100."""

    def __init__(self, predictor, max_batch: int, device_lock=None):
        self.predictor = predictor
        self.max_batch = max_batch
        self.queue: "queue.Queue" = queue.Queue()
        self.batch_sizes = collections.deque(maxlen=100)
        self.groups = 0
        # shared with the service's ?sliding=1 path so ALL device work
        # stays serialized behind one lock
        self._device_lock = device_lock or threading.Lock()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def predict(self, image: np.ndarray) -> np.ndarray:
        done = threading.Event()
        slot: dict = {}
        self.queue.put((image, done, slot))
        done.wait()
        if "error" in slot:
            raise slot["error"]
        return slot["result"]

    def _worker(self):
        # Inference mode is per thread: this thread runs the forwards.
        with torch.inference_mode():
            while True:
                group = [self.queue.get()]
                while len(group) < self.max_batch:
                    try:
                        group.append(self.queue.get_nowait())
                    except queue.Empty:
                        break
                self._run(group)

    def _run(self, group):
        images = [g[0] for g in group]
        try:
            padded = images + [images[0]] * (self.max_batch - len(images))
            with self._device_lock:
                self.groups += 1
                preds = self.predictor.predict_batch(padded)[: len(images)]
            self.batch_sizes.append(len(images))
            for (_, done, slot), pred in zip(group, preds):
                slot["result"] = pred
                done.set()
        except Exception as e:  # propagate to every waiter
            for _, done, slot in group:
                slot["error"] = e
                done.set()


class SegmentationService:
    """Predictor wrapper with warmup and single-device serialization
    (micro-batched when serve_batch > 1)."""

    def __init__(
        self,
        cfg: Config,
        checkpoint: Optional[str] = None,
        artifact: Optional[str] = None,
        serve_batch: int = 1,
        int8_calib_images: Optional[list] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        # Argument combinations are refused before the loads.
        if artifact and serve_batch > 1:
            raise ValueError("--serve-batch needs a live checkpoint predictor; an exported "
                             "artifact has a fixed baked-in batch size")
        if artifact and int8_calib_images:
            raise ValueError("int8 calibration applies to a live checkpoint predictor; an "
                             "exported artifact's numerics are baked in (pass --int8 to "
                             "`export` instead)")
        self.cfg = cfg
        self.batcher: Optional[_MicroBatcher] = None
        self._lock = threading.Lock()
        self.int8_convs = 0
        self.predictor: Union[Predictor, ArtifactPredictor]
        if artifact:
            self.predictor = ArtifactPredictor(artifact, device)
            # The artifact describes itself: serve its true shape.
            manifest = self.predictor.manifest
            self.cfg = cfg.replace(
                model=dataclasses.replace(cfg.model, num_classes=self.predictor.num_classes,
                                          backbone=manifest.get("backbone", cfg.model.backbone)),
                data=dataclasses.replace(cfg.data, crop_size=self.predictor.size),
            )
        else:
            self.predictor = Predictor(cfg, checkpoint, device=device)
            if int8_calib_images:
                calib = [np.asarray(Image.open(p).convert("RGB")) for p in int8_calib_images]
                self.int8_convs = self.predictor.quantize(
                    calib, percentile=cfg.train.int8_percentile)
            if serve_batch > 1:
                self.batcher = _MicroBatcher(self.predictor, serve_batch,
                                             device_lock=self._lock)
        self.serve_batch = serve_batch
        self.source = "artifact" if artifact else "checkpoint"
        self.warm = False

    def warmup(self):
        size = self.cfg.data.crop_size
        dummy = np.zeros((size, size, 3), np.uint8)
        if self.batcher is not None:
            self.batcher.predict(dummy)  # the fixed batch the batcher serves
        else:
            with self._lock:
                self.predictor.predict_array(dummy)
        self.warm = True

    @staticmethod
    def decode(image_bytes: bytes) -> np.ndarray:
        """Image file bytes -> HWC uint8 RGB; ValueError/OSError if bad."""
        return np.asarray(Image.open(io.BytesIO(image_bytes)).convert("RGB"))

    def predict_image(self, image: np.ndarray, color: bool = False, sliding: bool = False) -> bytes:
        """HWC uint8 image -> PNG bytes of its label map (or colorized)."""
        if self.batcher is not None and not sliding:
            pred = self.batcher.predict(image)
        else:
            with self._lock:
                if sliding:
                    pred = self.predictor.predict_sliding(image)
                else:
                    pred = self.predictor.predict_array(image)
        if color:
            out = Image.fromarray(decode_segmap(pred, self.cfg.model.num_classes))
        else:
            out = Image.fromarray(pred.astype(np.uint8), mode="L")
        buf = io.BytesIO()
        out.save(buf, format="PNG")
        return buf.getvalue()

    def info(self) -> dict:
        return {
            "backbone": self.cfg.model.backbone,
            "num_classes": self.cfg.model.num_classes,
            "crop_size": self.cfg.data.crop_size,
            "output_stride": self.cfg.model.output_stride,
            # An artifact's numerics are its own; its tail is always the plain one.
            "compute_dtype": self.cfg.model.compute_dtype if self.source == "checkpoint" else None,
            "fused_tail": self.cfg.model.fused_tail and self.source == "checkpoint",
            "device": str(self.predictor.device),
            "warm": self.warm,
            "source": self.source,
            "geometry": "letterbox",
            "int8_convs": self.int8_convs,
            "serve_batch": self.serve_batch,
            "recent_batch_sizes": (
                list(self.batcher.batch_sizes)[-20:] if self.batcher else []
            ),
        }


def _make_handler(service: SegmentationService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet by default
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/healthz":
                self._json(200, {"status": "ok", "warm": service.warm})
            elif path == "/info":
                self._json(200, service.info())
            else:
                self._json(404, {"error": f"unknown path {path}"})

        def do_POST(self):
            path, _, query = self.path.partition("?")
            if path != "/predict":
                self._json(404, {"error": f"unknown path {path}"})
                return
            opts = dict(kv.split("=", 1) for kv in query.split("&") if "=" in kv)
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                self._json(400, {"error": "malformed Content-Length header"})
                return
            if length <= 0:
                self._json(400, {"error": "empty body; POST image bytes"})
                return
            data = self.rfile.read(length)
            try:
                image = service.decode(data)
            except (ValueError, OSError) as e:  # undecodable image: the client's fault
                self._json(400, {"error": str(e)[:200]})
                return
            try:
                png = service.predict_image(
                    image,
                    color=opts.get("color") == "1",
                    sliding=opts.get("sliding") == "1",
                )
            except Exception as e:  # device or internal failure
                self._json(500, {"error": str(e)[:200]})
                return
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("Content-Length", str(len(png)))
            self.end_headers()
            self.wfile.write(png)

    return Handler


class InferenceServer:
    """ThreadingHTTPServer wrapper with background start/stop (tests,
    embedding) and a blocking serve_forever (CLI)."""

    def __init__(
        self,
        cfg: Config,
        checkpoint: Optional[str] = None,
        host: str = "127.0.0.1",
        port: int = 8500,
        artifact: Optional[str] = None,
        serve_batch: int = 1,
        int8_calib_images: Optional[list] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        self.service = SegmentationService(
            cfg, checkpoint, artifact=artifact, serve_batch=serve_batch,
            int8_calib_images=int8_calib_images, device=device,
        )
        self.httpd = ThreadingHTTPServer((host, port), _make_handler(self.service))
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self, warmup: bool = True):
        if warmup:
            self.service.warmup()
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def serve_forever(self, warmup: bool = True):
        if warmup:
            self.service.warmup()
        self.httpd.serve_forever()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
