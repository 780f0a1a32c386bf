"""Weight carriers: zs3_tpu (flax) variables -> the port's state_dicts.

`state_dict_from_flax` takes zs3_tpu's ``{"params", "batch_stats"}``
tree of a DeepLab with any of its encoders (ResNet, Xception,
MobileNetV2, DRN), as nested mappings of arrays, and returns the
state_dict of zs3_tpu_torch.models.deeplab.DeepLab:

  * conv kernels HWIO -> OIHW;
  * BN scale/bias -> weight/bias, mean/var -> running_mean/running_var
    (eval reads the running statistics only; the momentum is a module
    setting: flax's 0.9 is torch's 0.1);
  * flax module paths (encoder/layer1_block0/conv1/conv/kernel,
    encoder/block4/sep1/depthwise/conv/kernel, ...) -> the upstream
    checkpoints' names (backbone.layer1.0.conv1.weight,
    backbone.block4.rep.4.conv1.weight, ...).

`gmmn_state_dict_from_flax` does the same for the GMMN generator's
Dense params, and `scales_from_flax` for an int8 calibration: zs3_tpu's
conv paths (``encoder/layer1_block0/conv1/conv``) become the port's conv
names (``backbone.layer1.0.conv1``), the ones its `quant_path` holds.
"""

from __future__ import annotations

import json
import re
from collections import OrderedDict
from typing import Any, Dict, Iterator, Mapping, Tuple, Union

import numpy as np
import torch

_BN_FIELDS = {
    "scale": "weight",
    "bias": "bias",
    "mean": "running_mean",
    "var": "running_var",
}
_BLOCK = re.compile(r"layer([1-4])_block(\d+)")


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _resnet_module(path: Tuple[str, ...]) -> str:
    if path[0] == "stem_conv":
        return "conv1"
    if path[0] == "stem_bn":
        return "bn1"
    m = _BLOCK.fullmatch(path[0])
    if m is None or len(path) < 2:
        raise ValueError(f"unrecognized resnet entry: {'/'.join(path)}")
    return f"layer{m.group(1)}.{m.group(2)}.{_bottleneck_module(path)}"


def _bottleneck_module(path: Tuple[str, ...]) -> str:
    """A Bottleneck's sub-path (its name first) -> torchvision's name in it."""
    sub = path[1]
    if sub == "downsample_conv":
        return "downsample.0"
    if sub == "downsample_bn":
        return "downsample.1"
    if re.fullmatch(r"(conv|bn)[1-3]", sub):
        return sub
    raise ValueError(f"unrecognized bottleneck entry: {'/'.join(path)}")


# A SeparableConv's parts -> the upstream SeparableConv2d's.
_SEPARABLE = {"depthwise": "conv1", "bn_depth": "bn", "pointwise": "pointwise"}


def _xception_module(path: Tuple[str, ...]) -> str:
    head = path[0]
    if re.fullmatch(r"(conv|bn)[12]", head):
        return head
    if re.fullmatch(r"conv[345]", head) and len(path) > 1:
        if path[1] == "bn_point":  # the module-level BN after the unit
            return f"bn{head[-1]}"
        if path[1] in _SEPARABLE:
            return f"{head}.{_SEPARABLE[path[1]]}"
    m = re.fullmatch(r"block(\d+)", head)
    if m and len(path) > 1:
        if path[1] == "skip_conv":
            return f"{head}.skip"
        if path[1] == "skip_bn":
            return f"{head}.skipbn"
        unit = re.fullmatch(r"sep(\d+)", path[1])
        if unit and len(path) > 2:
            # rep holds [ReLU, SeparableConv, BN] per unit; block1 drops
            # its leading ReLU.
            sep = 3 * int(unit.group(1)) + (0 if head == "block1" else 1)
            if path[2] == "bn_point":
                return f"{head}.rep.{sep + 1}"
            if path[2] in _SEPARABLE:
                return f"{head}.rep.{sep}.{_SEPARABLE[path[2]]}"
    raise ValueError(f"unrecognized xception entry: {'/'.join(path)}")


def _mobilenet_blocks():
    """Per MobileNetV2 block: whether it has an expand conv."""
    from zs3_tpu_torch.models.mobilenet import CFG

    return [t != 1 for t, _, n, _ in CFG for _ in range(n)]


_MOBILENET_PARTS = ("expand_conv", "expand_bn", None, "depthwise", "depthwise_bn", None,
                    "project_conv", "project_bn")


def _mobilenet_module(path: Tuple[str, ...]) -> str:
    if path[0] == "stem_conv":
        return "features.0.0"
    if path[0] == "stem_bn":
        return "features.0.1"
    m = re.fullmatch(r"block(\d+)", path[0])
    blocks = _mobilenet_blocks()
    if m and int(m.group(1)) < len(blocks) and len(path) > 1:
        n = int(m.group(1))
        # Without an expand conv, the block's Sequential starts at the depthwise.
        parts = _MOBILENET_PARTS if blocks[n] else _MOBILENET_PARTS[3:]
        if path[1] in parts:
            return f"features.{n + 1}.conv.{parts.index(path[1])}"
    raise ValueError(f"unrecognized mobilenet entry: {'/'.join(path)}")


def _drn_module(path: Tuple[str, ...]) -> str:
    if path[0] == "stem_conv":
        return "layer0.0"
    if path[0] == "stem_bn":
        return "layer0.1"
    level = re.fullmatch(r"level([1278])", path[0])
    if level and len(path) > 1:
        part = re.fullmatch(r"(conv|bn)(\d+)", path[1])
        if part:  # [conv, BN, ReLU] per conv
            return (f"layer{level.group(1)}."
                    f"{3 * int(part.group(2)) + (part.group(1) == 'bn')}")
    block = re.fullmatch(r"level([3-6])_block(\d+)", path[0])
    if block and len(path) > 1:
        return f"layer{block.group(1)}.{block.group(2)}.{_bottleneck_module(path)}"
    raise ValueError(f"unrecognized drn entry: {'/'.join(path)}")


_ENCODERS = {
    "resnet": _resnet_module,
    "xception": _xception_module,
    "mobilenet": _mobilenet_module,
    "drn": _drn_module,
}


def backbone_kind(names) -> str:
    """The backbone family of zs3_tpu encoder module names (the first
    element of each path under ``encoder``): ResNet's blocks are
    layerN_blockM, DRN's levels levelN[_blockM], MobileNetV2's blocks
    block0..16, Xception's block1..20 beside conv1..5 and bn1..2."""
    names = set(names)
    if any(_BLOCK.fullmatch(n) for n in names):
        return "resnet"
    if any(re.fullmatch(r"level\d.*", n) for n in names):
        return "drn"
    if "block0" in names:
        return "mobilenet"
    if any(re.fullmatch(r"block\d+|conv\d|bn\d", n) for n in names):
        return "xception"
    raise ValueError(f"no backbone has the encoder modules {sorted(names)}")


def _family(backbone: str) -> str:
    return "resnet" if backbone.startswith("resnet") else backbone


def _module_name(path: Tuple[str, ...], kind: str) -> str:
    """flax path (without the leaf) -> the port's module name; `kind` is
    the encoder's family (resnet, xception, mobilenet, drn)."""
    head, rest = path[0], path[1:]
    if head == "encoder" and rest:
        return "backbone." + _ENCODERS[kind](rest)
    if head in ("aspp", "decoder"):
        name = rest[0]
        if name == "classifier":
            return "classifier"
        if rest[1:2] == ("conv",):
            return f"{name}.conv"
        if rest[1:2] == ("bn",):
            return f"{name}.bn"
    raise ValueError(f"unrecognized deeplab entry: {'/'.join(path)}")


def _kind(paths) -> str:
    """The encoder's family from the paths of a tree or a calibration
    (ResNet's when no path is under ``encoder``: it maps none)."""
    names = [p[1] for p in paths if p[0] == "encoder" and len(p) > 1]
    return backbone_kind(names) if names else "resnet"


def state_dict_from_flax(variables: Mapping[str, Mapping]) -> "OrderedDict[str, torch.Tensor]":
    """zs3_tpu DeepLab variables -> zs3_tpu_torch DeepLab state_dict (the
    encoder's family from its module names: backbone_kind)."""
    out: Dict[str, torch.Tensor] = {}
    bn_modules = set()
    leaves = [(path, value) for collection in ("params", "batch_stats")
              for path, value in _leaves(variables.get(collection, {}))]
    kind = _kind([path for path, _ in leaves])
    for path, value in leaves:
        arr = np.asarray(value, dtype=np.float32)
        leaf = path[-1]
        module = _module_name(path[:-1], kind)
        if path[-2] == "bn" and leaf in _BN_FIELDS:  # flax nn.BatchNorm
            out[f"{module}.{_BN_FIELDS[leaf]}"] = torch.from_numpy(arr.copy())
            bn_modules.add(module)
        elif leaf == "kernel":
            if arr.ndim != 4:
                raise ValueError(f"{'/'.join(path)}: expected an HWIO kernel")
            out[f"{module}.weight"] = torch.from_numpy(
                np.ascontiguousarray(arr.transpose(3, 2, 0, 1))
            )
        elif leaf == "bias":
            out[f"{module}.bias"] = torch.from_numpy(arr.copy())
        else:
            raise ValueError(f"unrecognized leaf: {'/'.join(path)}")
    for module in bn_modules:
        out[f"{module}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return OrderedDict(sorted(out.items()))


def gmmn_state_dict_from_flax(params: Mapping[str, Mapping]) -> "OrderedDict[str, torch.Tensor]":
    """zs3_tpu GMMNGenerator params -> zs3_tpu_torch GMMNGenerator state_dict:
    each Dense ``kernel`` (in, out) becomes the Linear ``weight`` (out, in)
    and ``bias`` stays ``bias``; layer names (hidden0.., out) carry over."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _leaves(params.get("params", params)):
        if len(path) != 2 or path[1] not in ("kernel", "bias"):
            raise ValueError(f"unrecognized gmmn entry: {'/'.join(path)}")
        arr = np.asarray(value, dtype=np.float32)
        if path[1] == "kernel":
            if arr.ndim != 2:
                raise ValueError(f"{'/'.join(path)}: expected an (in, out) kernel")
            out[f"{path[0]}.weight"] = torch.from_numpy(np.ascontiguousarray(arr.T))
        else:
            out[f"{path[0]}.bias"] = torch.from_numpy(arr.copy())
    return OrderedDict(sorted(out.items()))


def scales_from_flax(scales: Union[str, Mapping[Any, float]]) -> Dict[str, float]:
    """A zs3_tpu int8 calibration -> the port's: {conv name: input absmax}.

    `scales` maps zs3_tpu conv module paths (tuples, or 'a/b/c' strings) to
    absmaxes, or is the JSON text of zs3_tpu.quant.scales_to_json.  A conv's
    path is its kernel's param path short of the leaf, so it maps as the
    kernel does, the encoder's family as in state_dict_from_flax."""
    if isinstance(scales, str):
        scales = json.loads(scales)
    keyed = {(tuple(path.split("/")) if isinstance(path, str) else tuple(path)): float(value)
             for path, value in scales.items()}
    kind = _kind(list(keyed))
    return {_module_name(key, kind): value for key, value in keyed.items()}


# Classifier heads of the upstream checkpoints, which DeepLab has no use for.
_HEADS = ("fc.", "classifier.")


def load_pretrained_backbone(model: torch.nn.Module, pth: str, backbone: str) -> torch.nn.Module:
    """Load an upstream-named backbone .pth (torchvision ResNet, or the
    Xception, MobileNetV2 and DRN namings of tests/torch_oracle_backbones.py)
    into `model.backbone`, in place; returns the model.

    Accepts a bare state_dict or {"state_dict": ...}, drops a classifier
    head (fc.*, classifier.*), and refuses, naming the first one, any key
    the backbone lacks, any of its keys the file lacks (BN's
    num_batches_tracked may be absent) and any tensor of another shape,
    before it writes anything."""
    if _family(backbone) != _family(model.backbone_name):
        raise ValueError(f"{pth}: backbone {backbone!r} is not the model's "
                         f"({model.backbone_name!r})")
    state = torch.load(pth, map_location="cpu", weights_only=True)
    if "state_dict" in state:
        state = state["state_dict"]
    state = {k: v for k, v in state.items() if not k.startswith(_HEADS)}
    target = model.backbone.state_dict()
    extra = [k for k in state if k not in target]
    if extra:
        raise ValueError(f"{pth}: unexpected key {extra[0]!r} ({len(extra)} in all) "
                         f"for the {backbone} backbone")
    missing = [k for k in target if k not in state and not k.endswith("num_batches_tracked")]
    if missing:
        raise ValueError(f"{pth}: missing key {missing[0]!r} ({len(missing)} in all) "
                         f"of the {backbone} backbone")
    for key, value in state.items():
        if tuple(value.shape) != tuple(target[key].shape):
            raise ValueError(f"{pth}: {key} has shape {tuple(value.shape)}, "
                             f"the {backbone} backbone's is {tuple(target[key].shape)}")
    model.backbone.load_state_dict(state, strict=False)
    return model
