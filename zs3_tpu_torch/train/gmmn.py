"""ZS3Net zero-shot training: the GMMN generator step and classifier
retraining (port of zs3_tpu.train.gmmn).

Per batch, with the seen-class trunk frozen (SURVEY.md §3.3):

  1. extract real 256-d pixel features at the os4 grid, labels
     downsampled to that grid, and sample up to `pixels_per_class`
     pixels of every class;
  2. generator step: MMD between generated features (class embedding +
     noise) and each seen class's real features; Adam on the generator;
  3. classifier step: generated unseen-class features next to real seen
     ones retrain the split 1x1 classifier with CE; Adam on it.

With `gmmn.graph_context` the generator is GraphContextGMMN: each sampled
pixel conditions on its own image's class-adjacency graph (computed on
the full-resolution labels), and slots without a real pixel on the
batch's graph with `generic_context_fallback`.  With
`gmmn.self_training` (ZS5, train/self_training.py) pseudo-labelled unseen
pixels are real features for both updates.

The MMD runs on `KernelSum` (kernels K2/K3, ops/mmd_kernels.py) on the
GPU, and on their plain versions on the CPU.  Validation
splices the retrained classifier into the trunk and reports
seen/unseen/harmonic mIoU through the eval step (kernel K1), or the
ms+flip TTA step when `train.eval_scales`/`eval_flip` ask for it, and
writes a checkpoint of the generator and the classifier with their
optimizers under ``<checkname>-gmmn``; `train.gmmn_resume` restores one.

With `train.int8_features` the frozen trunk extracts the step's features
with int8 convs (quant.quantized(trunk scales), calibrated once on the
first 2 val batches), and validation runs int8 too; `train.int8_eval`
makes validation alone int8.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from zs3_tpu_torch import quant
from zs3_tpu_torch.core.config import Config, TrainConfig
from zs3_tpu_torch.core.device import resolve_device
from zs3_tpu_torch.data.loader import make_data_loader
from zs3_tpu_torch.metrics.evaluator import Evaluator
from zs3_tpu_torch.models.deeplab import DeepLab
from zs3_tpu_torch.models.gmmn import GMMNGenerator, build_gmmn, init_gmmn
from zs3_tpu_torch.ops.mmd_kernels import batched_kernel_mmd_loss
from zs3_tpu_torch.ops.sampling import (
    downsample_labels, draw_scores, neighbor_lists_from_adjacency, per_image_adjacency,
    sample_class_pixels, top_k_lower_first,
)
from zs3_tpu_torch.train.seen import (
    build_eval_model, calibrate_on_val, device_batch, preprocess_on_device, select_eval_step,
    step_generator,
)
from zs3_tpu_torch.utils.logging import MetricLogger
from zs3_tpu_torch.utils.saver import Saver

Params = Dict[str, torch.Tensor]
Draws = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
Context = Optional[Tuple[torch.Tensor, torch.Tensor]]  # neighbour ids, validity (C, P, K)


def extract_classifier(model: DeepLab) -> Params:
    """The trunk's 1x1 classifier as {"kernel": (D, C), "bias": (C,)},
    zs3_tpu's layout (the conv weight (C, D, 1, 1) transposed)."""
    conv = model.classifier
    return {
        "kernel": conv.weight.detach()[:, :, 0, 0].t().contiguous(),
        "bias": conv.bias.detach().clone(),
    }


@torch.no_grad()
def splice_classifier(model: DeepLab, cls_params: Params) -> DeepLab:
    """Write a (D, C) classifier back into the model's 1x1 conv, in place."""
    model.classifier.weight.copy_(cls_params["kernel"].t()[:, :, None, None])
    model.classifier.bias.copy_(cls_params["bias"])
    return model


def mmd_training_masks(
    real_mask: torch.Tensor, seen_mask_f: torch.Tensor, self_training: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(fake_mask, real_mask) the generator's MMD trains against.

    ZS3: only seen classes have real features, so both sides are
    restricted to them.  ZS5 (self_training): pseudo-labelled unseen
    pixels are targets too, and the generator trains on every class."""
    if self_training:
        return torch.ones_like(real_mask), real_mask
    num_classes, budget = real_mask.shape
    fake_mask = seen_mask_f[:, None].expand(num_classes, budget)
    return fake_mask, real_mask * seen_mask_f[:, None]


def classifier_training_set(
    real: torch.Tensor,
    real_mask: torch.Tensor,
    fake: torch.Tensor,
    unseen_mask: torch.Tensor,
    self_training: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(features (C, P, D), mask (C, P)) the classifier CE retrains on.

    ZS3: unseen rows are all generated, seen rows real under their sample
    mask.  ZS5 (self_training): real features at pseudo-labelled unseen
    pixels win and generated ones fill only the empty unseen slots."""
    unseen_row = unseen_mask[:, None] > 0
    if self_training:
        use_fake = unseen_row[..., None] & (real_mask[..., None] <= 0)
    else:
        use_fake = unseen_row[..., None]
    feats = torch.where(use_fake, fake, real)
    mask = torch.where(unseen_row, torch.ones_like(real_mask), real_mask)
    return feats, mask


def generic_context_fallback(
    nb: torch.Tensor, nbm: torch.Tensor, adj: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Give the classes with an empty neighbour list the batch's generic
    context: the K classes of highest total adjacency mass (ties to the
    lower id, as `jax.lax.top_k`).

    Classes absent from the batch (every unseen class in ZS3, whose
    images are filtered out) have empty adjacency rows, a zero context
    the generator never sees in training; generating unseen features from
    it collapses zero-shot transfer (zs3_tpu.train.gmmn measured unseen
    mIoU 0.027 against 0.194 plain on the context-tint synthetic split)."""
    mass_vals, mass_idx = top_k_lower_first(adj.sum(0), nb.shape[-1])
    row_empty = (nbm.sum(-1) == 0)[:, None]
    nb = torch.where(row_empty, mass_idx[None, :].to(nb.dtype), nb)
    nbm = torch.where(row_empty, (mass_vals > 0).float()[None, :], nbm)
    return nb, nbm


def select_mmd(backend: str, device: Union[str, torch.device]):
    """The batched MMD for `mmd_backend` on `device`.

    The port has one: `batched_kernel_mmd_loss` on KernelSum, which
    launches K2/K3 for CUDA tensors and takes their plain versions for CPU
    tensors, with no fallback between them.  'jnp' names zs3_tpu's XLA
    oracle; on the CPU every backend is the plain version already, and on
    the GPU the choice is refused rather than sent to a second path."""
    if backend not in ("auto", "pallas", "jnp"):
        raise ValueError(f"unknown mmd_backend {backend!r}")
    if backend == "jnp" and torch.device(device).type == "cuda":
        raise ValueError(
            "mmd_backend='jnp' selects zs3_tpu's XLA oracle; the port runs the "
            "MMD on its kernels K2/K3 on the GPU (use 'auto')"
        )
    return batched_kernel_mmd_loss


class ZS3Step:
    """One ZS3 step (zs3_tpu.train.gmmn.make_zs3_step): features ->
    sample -> generator MMD update -> classifier CE update.

    Holds the generator (GraphContextGMMN with cfg.gmmn.graph_context),
    the classifier params {"kernel", "bias"} and their Adam optimizers.
    Step `step`'s draws are a function of (seed, step) alone (zs3_tpu
    folds the step into its key), so a resumed run draws what an
    uninterrupted one would; the graph branch draws nothing.  `body` also takes the draws
    as an argument (tests feed it zs3_tpu's); the gradients of the last
    update stay in the parameters' `.grad`.  With `int8_scales` the trunk
    extracts its features under quant.quantized(int8_scales).
    """

    def __init__(
        self,
        model: DeepLab,
        generator: GMMNGenerator,
        cls_params: Params,
        embeddings: torch.Tensor,
        unseen_mask: torch.Tensor,
        cfg: Config,
        seed: int,
        int8_scales: Optional[quant.Scales] = None,
    ):
        self.model = model.eval()
        self.int8_scales = int8_scales
        self.generator = generator
        self.embeddings = embeddings
        self.unseen_mask = unseen_mask
        self.seen_mask = 1.0 - unseen_mask
        self.num_classes = int(unseen_mask.shape[0])
        self.budget = cfg.gmmn.pixels_per_class
        self.noise_dim = cfg.gmmn.noise_dim
        self.sigmas = tuple(float(s) for s in cfg.gmmn.mmd_sigmas)
        self.self_training = cfg.gmmn.self_training
        self.graph_context = cfg.gmmn.graph_context
        self.max_neighbors = cfg.gmmn.max_graph_neighbors
        self.device_preprocess = cfg.data.device_preprocess
        self.device = embeddings.device
        self.mmd_fn = select_mmd(cfg.gmmn.mmd_backend, self.device)
        self.cls = {k: v.detach().clone().requires_grad_(True) for k, v in cls_params.items()}
        self.gen_opt = torch.optim.Adam(generator.parameters(), lr=cfg.optim.gmmn_lr)
        self.cls_opt = torch.optim.Adam(list(self.cls.values()), lr=cfg.optim.classifier_lr)
        self.seed = seed

    def features(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Frozen-trunk features (N, D) f32 and their labels (N,) at the
        feature grid.  no_grad, not inference_mode: KernelSum saves the
        real features for its backward."""
        int8 = quant.quantized(self.int8_scales) if self.int8_scales else contextlib.nullcontext()
        with torch.no_grad(), int8:
            feats = self.model.forward_features(batch["image"])
        b, h, w, d = feats.shape
        labels = downsample_labels(batch["label"], (h, w))
        return feats.reshape(-1, d).float(), labels.reshape(-1)

    def draw(self, num_pixels: int, step: int) -> Draws:
        """(scores (C, N), noise1 (C, P, Z), noise2 (C, P, Z)) of step
        `step` (0 for the first)."""
        rng = step_generator(self.seed, step, self.device)
        shape = (self.num_classes, self.budget, self.noise_dim)
        u = draw_scores(self.num_classes, num_pixels, rng, self.device)
        noise1 = torch.randn(shape, generator=rng, device=self.device)
        noise2 = torch.randn(shape, generator=rng, device=self.device)
        return u, noise1, noise2

    def generate(self, noise: torch.Tensor, context: Context = None) -> torch.Tensor:
        """(C, P, feature_dim) features for every class from its embedding,
        and from its slots' neighbour embeddings under graph context."""
        emb = self.embeddings[:, None].expand(-1, noise.shape[1], -1)
        if context is None:
            return self.generator(emb, noise)
        neighbors, mask = context
        return self.generator(emb, noise, self.embeddings[neighbors.long()], mask)

    def sample(self, feats, labels, u, return_indices: bool = False):
        return sample_class_pixels(feats, labels, self.num_classes, self.budget, u,
                                   return_indices=return_indices)

    def context(self, batch_labels: torch.Tensor, pix_idx: torch.Tensor,
                real_mask: torch.Tensor, grid_pixels: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(neighbour ids (C, P, K), validity (C, P, K)) of the sampled
        slots: a real pixel takes its image's neighbour list of its class,
        an empty slot the batch's, with the generic fallback.  The graphs
        come from the full-resolution (B, H, W) labels; `pix_idx` (C, P)
        indexes the feature grid, `grid_pixels` (h * w) to an image, so its
        image is pix_idx // grid_pixels."""
        c, k = self.num_classes, self.max_neighbors
        adj_img = per_image_adjacency(batch_labels, c)  # (B, C, C)
        nb_img, nbm_img = neighbor_lists_from_adjacency(adj_img, k)  # (B, C, K)
        img_ids = pix_idx // grid_pixels
        rows = torch.arange(c, device=pix_idx.device)[:, None]
        nb_pix, nbm_pix = nb_img[img_ids, rows], nbm_img[img_ids, rows]  # (C, P, K)
        adj_b = adj_img.sum(0)
        nb_b, nbm_b = generic_context_fallback(*neighbor_lists_from_adjacency(adj_b, k), adj_b)
        has_pixel = real_mask[..., None] > 0
        return (torch.where(has_pixel, nb_pix, nb_b[:, None]),
                torch.where(has_pixel, nbm_pix, nbm_b[:, None]))

    def generator_update(self, real, real_mask, noise1, context: Context = None) -> torch.Tensor:
        fake_mask, mmd_real_mask = mmd_training_masks(
            real_mask, self.seen_mask, self.self_training
        )
        self.gen_opt.zero_grad(set_to_none=True)
        fake = self.generate(noise1, context)
        mmd = self.mmd_fn(fake, real, fake_mask, mmd_real_mask, self.sigmas)
        mmd.backward()
        self.gen_opt.step()
        return mmd.detach()

    def classifier_update(self, real, real_mask, noise2, context: Context = None) -> torch.Tensor:
        with torch.no_grad():
            fake_all = self.generate(noise2, context)
        feats, mask = classifier_training_set(
            real, real_mask, fake_all, self.unseen_mask, self.self_training
        )
        self.cls_opt.zero_grad(set_to_none=True)
        logits = torch.einsum("cpd,dk->cpk", feats, self.cls["kernel"]) + self.cls["bias"]
        logp = F.log_softmax(logits, dim=-1)
        # Row c's label is c: its own class's log-probability.
        diag = torch.arange(self.num_classes, device=logp.device)
        nll = -logp.gather(2, diag[:, None, None].expand(-1, logp.shape[1], 1))[..., 0]
        ce = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        ce.backward()
        self.cls_opt.step()
        return ce.detach()

    def body(self, batch: Dict[str, torch.Tensor], draws: Optional[Draws] = None,
             step: Optional[int] = None):
        """The step on `batch` with the given draws, or with step `step`'s.
        With data.device_preprocess the batch's images are uint8, normalized
        and flipped here by step `step`'s flip mask (a stream of its own:
        the other draws are those of the step without it)."""
        if self.device_preprocess:
            if step is None:
                raise ValueError("device_preprocess draws step `step`'s flips: pass step")
            batch = preprocess_on_device(batch, self.seed, step)
        feats, labels = self.features(batch)
        u, noise1, noise2 = draws if draws is not None else self.draw(labels.shape[0], step)
        context = None
        if self.graph_context:
            real, real_mask, pix_idx = self.sample(feats, labels, u, return_indices=True)
            grid_pixels = labels.shape[0] // batch["label"].shape[0]
            context = self.context(batch["label"], pix_idx, real_mask, grid_pixels)
        else:
            real, real_mask = self.sample(feats, labels, u)
        mmd = self.generator_update(real, real_mask, noise1, context)
        ce = self.classifier_update(real, real_mask, noise2, context)
        return {"mmd": mmd, "cls_ce": ce}

    __call__ = body


def make_zs3_eval_step(
    num_classes: int, ignore_index: int = 255, train_cfg: TrainConfig = TrainConfig(),
    scales: Optional[quant.Scales] = None,
):
    """eval_step(model, cls_params, batch) -> (C, C) confusion: splice the
    classifier, then the eval step `train_cfg` selects (features,
    classify, K1, confusion; or ms+flip TTA), int8 under `scales`."""
    eval_step = select_eval_step(num_classes, ignore_index, train_cfg, scales)

    def zs3_eval_step(model: DeepLab, cls_params: Params, batch) -> torch.Tensor:
        return eval_step(splice_classifier(model, cls_params), batch)

    return zs3_eval_step


def class_embeddings(cfg: Config, num_classes: int) -> np.ndarray:
    """(num_classes, embed_dim) class embeddings, as zs3_tpu's GMMNTrainer
    loads them: for `pascal` and `context` the rows of VOC_CLASSES or
    CONTEXT_CLASSES by name, from the file at cfg.data.embedding_path or
    the per-name fallback; for `synthetic` the synthetic classes' own, or
    `class_<i>` from the file."""
    from zs3_tpu_torch.data.embeddings import load_class_embeddings

    if cfg.data.dataset != "synthetic":
        from zs3_tpu_torch.data.classes import CONTEXT_CLASSES, VOC_CLASSES

        names = CONTEXT_CLASSES if cfg.data.dataset == "context" else VOC_CLASSES
        emb = load_class_embeddings(names, cfg.data.embedding_path, cfg.gmmn.embed_dim)
    elif cfg.data.embedding_path is None:
        # The synthetic classes' appearance is linear in these embeddings,
        # so zero-shot transfer is well posed.
        from zs3_tpu_torch.data.synthetic import synthetic_class_embeddings

        emb = synthetic_class_embeddings(num_classes, cfg.gmmn.embed_dim)
    else:
        emb = load_class_embeddings(
            [f"class_{i}" for i in range(num_classes)],
            cfg.data.embedding_path,
            cfg.gmmn.embed_dim,
        )
    if emb.shape[1] != cfg.gmmn.embed_dim:
        raise ValueError(
            f"embedding file {cfg.data.embedding_path!r} has dim {emb.shape[1]}, "
            f"but gmmn.embed_dim={cfg.gmmn.embed_dim} (the generator was sized for "
            "the latter; set gmmn.embed_dim to match the file)"
        )
    return emb


class GMMNTrainer:
    """Step 2 of the pipeline: zero-shot transfer via generated features.

    The trunk comes from cfg.train.resume (a `train-seen` checkpoint or a
    bare `.pt` state_dict) or a seeded init; the classifier starts from
    the trunk's own, or with the generator from cfg.train.gmmn_resume."""

    checkpoint_suffix = "-gmmn"

    def __init__(self, cfg: Config, device: Union[str, torch.device] = "cuda",
                 saver: Optional[Saver] = None):
        device = resolve_device(device)
        self.train_loader, self.val_loader, num_classes = make_data_loader(
            cfg.data, pin_memory=device.type == "cuda")
        if cfg.model.num_classes != num_classes:
            cfg = cfg.replace(model=dataclasses.replace(cfg.model, num_classes=num_classes))
        self.cfg = cfg
        self.device = device
        self.num_classes = num_classes
        self.model = build_eval_model(cfg, device)
        if not cfg.train.resume:
            warnings.warn(
                "GMMNTrainer is starting from a randomly initialised trunk (no "
                "--resume): its features are meaningless and zero-shot "
                "training will not transfer.",
                stacklevel=2,
            )
        emb = class_embeddings(cfg, num_classes)
        self.embeddings = torch.from_numpy(emb).to(device)
        self.unseen = tuple(cfg.data.unseen_classes)
        unseen_mask = torch.zeros(num_classes, dtype=torch.float32)
        unseen_mask[list(self.unseen)] = 1.0
        # Distinct streams from one seed: trunk init (seed), generator
        # init (seed + 1), the step's draws (seed + 2).
        self.generator = init_gmmn(build_gmmn(cfg.gmmn), cfg.train.seed + 1).to(device)
        self._int8_scales: Optional[quant.Scales] = None
        self.step = ZS3Step(
            self.model, self.generator, extract_classifier(self.model),
            self.embeddings, unseen_mask.to(device), cfg, seed=cfg.train.seed + 2,
            int8_scales=self.trunk_int8_scales() if cfg.train.int8_features else None,
        )
        # Validation runs int8 under int8_features too: the classifier was
        # trained on int8 features, and a float trunk is one it never saw.
        int8_eval = cfg.train.int8_eval or cfg.train.int8_features
        self.eval_fn = make_zs3_eval_step(num_classes, cfg.data.ignore_index, cfg.train,
                                          self.trunk_int8_scales() if int8_eval else None)
        self.steps_per_epoch = cfg.train.steps_per_epoch or len(self.train_loader)
        self.global_step = 0  # ZS3 steps taken (zs3_tpu's gen_state.step)
        self.best_hiou = 0.0
        if cfg.train.gmmn_resume:
            self.load_checkpoint(Saver.restore(cfg.train.gmmn_resume))
            # Carry the best-so-far across a resume (see SeenTrainer).
            self.best_hiou = float(
                Saver.read_meta(cfg.train.gmmn_resume).get("best_metric", 0.0))
        self.saver = saver or Saver(cfg.train.checkpoint_dir, cfg.data.dataset,
                                    cfg.train.checkname + self.checkpoint_suffix, cfg,
                                    keep=cfg.train.keep_checkpoints)
        self.logger = MetricLogger(self.saver.directory)

    def trunk_int8_scales(self) -> quant.Scales:
        """The frozen trunk's int8 scales (forward_features: the classifier,
        the retrained head, stays float), calibrated once on the first 2 val
        batches; shared by int8_features and int8 validation."""
        if self._int8_scales is None:
            self._int8_scales = calibrate_on_val(
                self.model, self.val_loader, self.device, self.cfg.train.int8_percentile,
                forward=lambda model, x: model.forward_features(x))
        return self._int8_scales

    def checkpoint_payload(self) -> Dict:
        """Generator, classifier, both Adam states and the step."""
        return {
            "gen": self.generator.state_dict(),
            "cls": {k: v.detach() for k, v in self.step.cls.items()},
            "gen_opt": self.step.gen_opt.state_dict(),
            "cls_opt": self.step.cls_opt.state_dict(),
            "step": self.global_step,
        }

    @torch.no_grad()
    def load_checkpoint(self, payload: Dict):
        self.generator.load_state_dict(payload["gen"])
        for key, value in payload["cls"].items():
            self.step.cls[key].copy_(value)
        self.step.gen_opt.load_state_dict(payload["gen_opt"])
        self.step.cls_opt.load_state_dict(payload["cls_opt"])
        self.global_step = int(payload["step"])

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        self.train_loader.set_epoch(epoch)
        mmds, ces = [], []
        t0 = time.time()
        for i, batch in enumerate(self.train_loader):
            if i >= self.steps_per_epoch:
                break
            out = self.step(device_batch(batch, self.device), step=self.global_step)
            self.global_step += 1
            mmds.append(out["mmd"])
            ces.append(out["cls_ce"])
        stats = {
            "epoch": epoch,
            "mmd": float(torch.stack(mmds).mean()) if mmds else float("nan"),
            "cls_ce": float(torch.stack(ces).mean()) if ces else float("nan"),
            "epoch_seconds": time.time() - t0,
        }
        self.logger.log(self.global_step, stats, prefix="train")
        return stats

    def validate(self, epoch: int = 0) -> Dict[str, float]:
        """Zero-shot metrics of the current classifier; writes a
        checkpoint, `best` when the harmonic mIoU improved."""
        evaluator = Evaluator(self.num_classes, self.cfg.data.ignore_index, self.unseen)
        for batch in self.val_loader:
            evaluator.add_confusion(
                self.eval_fn(self.model, self.step.cls, device_batch(batch, self.device))
            )
        report = evaluator.compute().as_dict()
        self.logger.log(self.global_step, report, prefix="val")
        hiou = report.get("harmonic_miou") or 0.0
        is_best = hiou > self.best_hiou
        if is_best:
            self.best_hiou = hiou
        self.saver.save_checkpoint(self.checkpoint_payload(), self.global_step, self.best_hiou,
                                   is_best=is_best, extra={"epoch": epoch, **report})
        return report

    def fit(self) -> Dict[str, float]:
        stats: Dict[str, float] = {}
        report: Dict[str, float] = {}
        validated = False
        for epoch in range(self.cfg.train.epochs):
            stats = self.train_epoch(epoch)
            # eval_interval <= 0 means never validate (like --no-val).
            interval = self.cfg.train.eval_interval
            validated = interval > 0 and (epoch + 1) % interval == 0
            if validated:
                report = self.validate(epoch)
        if self.cfg.train.epochs and not validated:
            # --no-val, or epochs after the last validation: checkpoints
            # are otherwise written by validate() alone.
            self.saver.save_checkpoint(self.checkpoint_payload(), self.global_step,
                                       self.best_hiou, is_best=False,
                                       extra={"epoch": self.cfg.train.epochs - 1})
        return {**stats, **report}
