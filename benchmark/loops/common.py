"""What the loops share: the program's model made from the seed, the
reference's made from the same seed, and freeing the card between them."""

from __future__ import annotations

import gc
import importlib

import torch

from benchmark import inputs


def program_model(config: dict, seed: int, device):
    """The port's DeepLab of `config` on `device`, channels_last, with the
    benchmark's seeded weights (built on the meta device, so no host init
    runs)."""
    from zs3_tpu_torch.models.deeplab import DeepLab

    m = config["model"]
    with torch.device("meta"):
        model = DeepLab(
            backbone=m["backbone"], output_stride=m["output_stride"],
            num_classes=m["num_classes"], feature_dim=m["feature_dim"],
            low_level_dim=m["low_level_dim"], bn_momentum=m["bn_momentum"],
            bn_epsilon=m["bn_epsilon"], dropout=m["dropout"],
            dtype=getattr(torch, m["compute_dtype"]), layers=m.get("layers"),
        )
    template = model.state_dict()
    model = model.to_empty(device=device)
    model.load_state_dict(inputs.seeded_state(template, seed, device))
    return model.to(memory_format=torch.channels_last)


def reference_module(config: dict):
    """The module of `config`'s plain reference (its "reference" key), whose
    `build(config)` gives the model."""
    return importlib.import_module(config["reference"])


def reference_model(config: dict, seed: int, device):
    """The plain f32 reference of `config`, with the same seeded weights."""
    with torch.device("meta"):
        model = reference_module(config).build(config)
    template = model.state_dict()
    model = model.to_empty(device=device)
    model.load_state_dict(inputs.seeded_state(template, seed, device))
    return model


def exclude(config: dict, traffic: dict):
    return config["unseen_classes"] if traffic.get("seen_only") else ()


def free_card():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class tf32_off:
    """TF32 off for the reference's f32 convolutions and matmuls."""

    def __enter__(self):
        self.saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved
        return False
