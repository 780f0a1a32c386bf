"""Typed configuration tree for zs3_tpu_torch (a copy of zs3_tpu.core.config).

The reference scatters ~40 argparse flags across each train_*.py script
(reference: train_pascal.py main() [H per SURVEY.md]; config recorded only
as a parameters.txt dump). Here the whole experiment is a single nested
dataclass that serializes to JSON and is written into every checkpoint
directory, so a run is exactly reproducible from its config file.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """DeepLabv3+ assembly (reference: zs3/modeling/deeplab.py class DeepLab)."""

    backbone: str = "resnet101"  # resnet101 | resnet50 | xception | mobilenet | drn | resnest101
    output_stride: int = 16  # 16 or 8
    num_classes: int = 21
    # 256-d pre-logit pixel embedding width (the ZS3 feature tap).
    feature_dim: int = 256
    # low-level feature projection width in the decoder.
    low_level_dim: int = 48
    # bf16 compute on TPU; params always f32.
    compute_dtype: str = "bfloat16"
    bn_momentum: float = 0.9  # flax convention: ema = m*ema + (1-m)*batch
    bn_epsilon: float = 1e-5
    # Cross-replica BN axis; None relies on jit global-batch semantics.
    bn_axis_name: Optional[str] = None
    dropout: bool = True
    # Rematerialize backbone blocks (large-batch training at 513^2).
    remat: bool = False
    # Fused Pallas classify+resize inference tail (ops/pallas_tail.py);
    # engages on TPU at eval for exact-4x geometry, no-op elsewhere.
    # Measured negative result, kept flag-off (DESIGN.md §4 sixth fix).
    fused_tail: bool = False


@dataclass(frozen=True)
class GMMNConfig:
    """GMMN generator + MMD loss (reference: zs3/modeling/gmmn.py)."""

    embed_dim: int = 300  # word2vec class embeddings
    noise_dim: int = 300
    hidden_dim: int = 256
    feature_dim: int = 256  # must match ModelConfig.feature_dim
    num_hidden: int = 1
    dropout_rate: float = 0.0
    leaky_slope: float = 0.2
    # Multi-bandwidth Gaussian kernel scales (sigma values).
    mmd_sigmas: Tuple[float, ...] = (2.0, 5.0, 10.0, 20.0, 40.0, 80.0)
    # Fixed per-class pixel budget for jit-safe ragged sampling.
    pixels_per_class: int = 128
    # MMD backend, zs3_tpu's names: 'auto' and 'pallas' run the port's
    # kernels K2/K3 on the GPU at every budget (their plain versions on the
    # CPU); 'jnp' (zs3_tpu's XLA oracle) is refused on the GPU.
    mmd_backend: str = "auto"
    # Graph-context variant: aggregate neighbor class embeddings.
    graph_context: bool = False
    graph_hidden_dim: int = 256
    max_graph_neighbors: int = 8
    # ZS5 self-training mode: pseudo-labeled unseen pixels provide REAL
    # features to both the classifier CE and the MMD targets (reference
    # ZS5 retrains on the augmented label set); plain ZS3 substitutes
    # generated features for all unseen rows.  Set by ZS5Trainer.
    self_training: bool = False
    # Min softmax confidence for a pseudo-label to be written (ZS5
    # stage A); 0 disables thresholding and uses the fused argmax kernel.
    pseudo_confidence: float = 0.0


@dataclass(frozen=True)
class DataConfig:
    """Dataset selection and preprocessing (reference: zs3/dataloaders/)."""

    dataset: str = "pascal"  # pascal | context | synthetic
    root: str = "/data"
    use_sbd: bool = False
    base_size: int = 513
    crop_size: int = 513
    batch_size: int = 8
    eval_batch_size: int = 4
    ignore_index: int = 255
    # Unseen class indices (reference passes these as script flags).
    unseen_classes: Tuple[int, ...] = ()
    # ZS5Net weak/pseudo-label path (reference: VOCSegmentation weak_label).
    weak_label_dir: Optional[str] = None
    # Class-embedding .npy path; None -> deterministic fallback embeddings.
    embedding_path: Optional[str] = None
    # Ship uint8 train batches and normalize+flip on device inside the jit
    # step (4x less host->device traffic; SURVEY §7 device-side prep).
    device_preprocess: bool = False
    # Train input pipeline: 'python' (threaded, dependency-light) or
    # 'tfdata' (tf.data parallel decode + autotuned prefetch).
    input_pipeline: str = "python"
    num_workers: int = 4
    shuffle_seed: int = 0
    # Synthetic-dataset knobs (dataset='synthetic' only).  Class tints
    # are linear in the deterministic fallback embeddings at this dim;
    # set gmmn.embed_dim equal to it for an exactly-linear
    # embedding->appearance map (the zero-shot acceptance test does).
    synthetic_classes: int = 21
    synthetic_items: int = 64
    synthetic_embed_dim: int = 32
    # Fraction of the class tint blended over noise inside objects
    # (higher = more learnable appearance).
    synthetic_tint_weight: float = 0.75
    # Context-dependent appearance: fraction of each region's tint taken
    # from the mean tint of the classes it touches (> 0 makes the
    # graph-context GMMN conditioning informative; see data/synthetic.py).
    synthetic_context_tint: float = 0.0


@dataclass(frozen=True)
class OptimConfig:
    """SGD + poly schedule (reference: zs3/utils/lr_scheduler.py LR_Scheduler)."""

    lr: float = 0.007
    loss_type: str = "ce"  # ce | focal
    # Where the loss is computed: 'full' upsamples logits to input
    # resolution (reference semantics); 'feature' downsamples labels to
    # the os4 grid instead — skips the 513^2 x C logits forward+backward
    # chain (measured ~2% faster on v5e; mainly a memory saver).
    loss_at: str = "full"
    use_balanced_weights: bool = False
    momentum: float = 0.9
    weight_decay: float = 5e-4
    nesterov: bool = False
    schedule: str = "poly"  # poly | step | cos | const
    poly_power: float = 0.9
    warmup_steps: int = 0
    # Head params (ASPP/decoder/classifier) train at 10x backbone LR
    # (reference: DeepLab.get_1x_lr_params / get_10x_lr_params).
    head_lr_mult: float = 10.0
    # GMMN generator optimizer.
    gmmn_lr: float = 2e-4
    classifier_lr: float = 1e-2


@dataclass(frozen=True)
class TrainConfig:
    epochs: int = 50
    steps_per_epoch: Optional[int] = None  # None -> len(dataset)//batch
    eval_interval: int = 1
    checkpoint_dir: str = "run"
    checkname: str = "deeplab-resnet101"
    resume: Optional[str] = None
    # GMMN-stage checkpoint ({"gen","cls"} payload) to resume/evaluate.
    gmmn_resume: Optional[str] = None
    # Fine-tune semantics (reference --ft): load params/BN stats from the
    # checkpoint but restart the optimizer state, step count and schedule.
    finetune: bool = False
    seed: int = 0
    log_every: int = 20
    # TensorBoard scalars + image panels (reference TensorboardSummary.
    # visualize_image); JSONL metrics are always written regardless.
    tensorboard: bool = False
    keep_checkpoints: int = 3
    # Mesh axes: (name, size). Size -1 = all remaining devices.
    mesh_axes: Tuple[Tuple[str, int], ...] = (("data", -1),)
    donate_state: bool = True
    # Microbatches per optimizer step (train-seen).  data.batch_size is
    # the EFFECTIVE batch; the jit step lax.scan's over grad_accum
    # microbatches of batch_size/grad_accum, so activation memory is
    # bounded by the microbatch while schedules/step counts see one
    # step per loader batch.  BN stats update per microbatch (torch
    # accumulation semantics).
    grad_accum: int = 1
    # Validate with int8 PTQ convs (zs3_tpu.quant): calibrates on the
    # first two val batches, then evaluates the reference protocol with
    # the s8 x s8 MXU lowering — the one-flag way to measure the int8
    # deployment path's mIoU delta (`cli evaluate[-gmmn] --int8`).
    int8_eval: bool = False
    # Quantization-aware training (train-seen): every PTQ-eligible conv
    # trains on fake-quantized operands (int8 grid + straight-through
    # gradients, zs3_tpu.quant.qat) so the trunk learns weights that
    # survive the s8 x s8 deployment lowering.  Pair with int8_eval to
    # validate the deployed behavior; the checkpoint stays a plain
    # float checkpoint (fake-quant adds no parameters).
    qat: bool = False
    # Percentile of |conv input| to calibrate int8 activation scales to
    # (e.g. 99.99) instead of the absolute max — clips activation
    # outliers so the bulk of the range keeps its 8-bit resolution.
    # None = absmax.  Read when int8_eval or int8_features.
    int8_percentile: Optional[float] = None
    # GMMN/ZS5 stages: extract frozen-trunk features with int8 MXU convs
    # INSIDE the fused train step (`train-gmmn/train-zs5
    # --int8-features`).  The trunk is frozen and gradient-free there,
    # so this is pure inference acceleration (~1.4x measured on the
    # forward path) applied to the stage's dominant cost; scales
    # calibrate once from the first val batches.
    int8_features: bool = False
    # Test-time augmentation for validation: average softmax probs over
    # these input scales (+ horizontal mirror when eval_flip).  Defaults
    # reproduce the reference's single-scale protocol; (0.5, 0.75, 1.0,
    # 1.25, 1.5, 1.75) + flip is the DeepLab-lineage "ms+flip" mode.
    eval_scales: Tuple[float, ...] = (1.0,)
    eval_flip: bool = False


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    gmmn: GMMNConfig = field(default_factory=GMMNConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "Config":
        raw = json.loads(text)
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "Config":
        def build(dc_type, data):
            fields = {f.name: f for f in dataclasses.fields(dc_type)}
            kwargs = {}
            for key, value in data.items():
                if key not in fields:
                    continue
                ftype = fields[key].type
                if isinstance(value, dict) and dc_type is Config:
                    sub = {
                        "model": ModelConfig,
                        "gmmn": GMMNConfig,
                        "data": DataConfig,
                        "optim": OptimConfig,
                        "train": TrainConfig,
                    }[key]
                    kwargs[key] = build(sub, value)
                elif isinstance(value, list):
                    kwargs[key] = tuple(
                        tuple(v) if isinstance(v, list) else v for v in value
                    )
                else:
                    kwargs[key] = value
            return dc_type(**kwargs)

        return build(cls, raw)

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)


def voc_unseen_split(k: int) -> Tuple[int, ...]:
    """Incremental VOC unseen splits (paper arXiv:1906.00817 protocol).

    Order: cow, motorbike | airplane, sofa | cat, tv | train, bottle |
    chair, potted-plant.  Indices follow the VOC 21-class convention
    (0 = background).
    """
    order = (10, 14, 1, 18, 8, 20, 19, 5, 9, 16)
    if k not in (2, 4, 6, 8, 10):
        raise ValueError(f"VOC unseen split must be one of 2/4/6/8/10, got {k}")
    return order[:k]


def context_unseen_split(k: int) -> Tuple[int, ...]:
    """Incremental Pascal-Context (59-class) unseen splits.

    Order per paper: cow, motorbike | sofa, cat | boat, fence |
    bird, tvmonitor | keyboard, aeroplane.  Indices are positions in
    CONTEXT_CLASSES (zs3_tpu.data.classes).
    """
    from zs3_tpu_torch.data.classes import CONTEXT_CLASSES

    names = (
        "cow", "motorbike", "sofa", "cat", "boat",
        "fence", "bird", "tvmonitor", "keyboard", "aeroplane",
    )
    if k not in (2, 4, 6, 8, 10):
        raise ValueError(f"Context unseen split must be one of 2/4/6/8/10, got {k}")
    return tuple(CONTEXT_CLASSES.index(n) for n in names[:k])
