"""Weight carriers: zs3_tpu (flax) variables -> the port's state_dicts.

`state_dict_from_flax` takes zs3_tpu's ``{"params", "batch_stats"}``
tree of a DeepLab with a ResNet encoder, as nested mappings of arrays,
and returns the state_dict of zs3_tpu_torch.models.deeplab.DeepLab:

  * conv kernels HWIO -> OIHW;
  * BN scale/bias -> weight/bias, mean/var -> running_mean/running_var
    (eval reads the running statistics only; the momentum is a module
    setting: flax's 0.9 is torch's 0.1);
  * flax module paths (encoder/layer1_block0/conv1/conv/kernel, ...) ->
    torchvision and oracle names (backbone.layer1.0.conv1.weight, ...).

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


def _encoder_module(path: Tuple[str, ...]) -> str:
    """encoder sub-path (without the leaf) -> torchvision module name."""
    if path[0] == "stem_conv":
        return "backbone.conv1"
    if path[0] == "stem_bn":
        return "backbone.bn1"
    m = _BLOCK.fullmatch(path[0])
    if m is None:
        raise ValueError(f"unrecognized encoder entry: {'/'.join(path)}")
    block = f"backbone.layer{m.group(1)}.{m.group(2)}"
    sub = path[1]
    if sub == "downsample_conv":
        return f"{block}.downsample.0"
    if sub == "downsample_bn":
        return f"{block}.downsample.1"
    if re.fullmatch(r"(conv|bn)[1-3]", sub):
        return f"{block}.{sub}"
    raise ValueError(f"unrecognized encoder entry: {'/'.join(path)}")


def _module_name(path: Tuple[str, ...]) -> str:
    """flax path (without the leaf) -> the port's module name."""
    head, rest = path[0], path[1:]
    if head == "encoder":
        return _encoder_module(rest)
    if head in ("aspp", "decoder"):
        name = rest[0]
        if name == "classifier":
            return "classifier"
        if rest[1:2] == ("conv",):
            return f"{name}.conv"
        if rest[1:2] == ("bn",):
            return f"{name}.bn"
    raise ValueError(f"unrecognized deeplab entry: {'/'.join(path)}")


def state_dict_from_flax(variables: Mapping[str, Mapping]) -> "OrderedDict[str, torch.Tensor]":
    """zs3_tpu DeepLab variables -> zs3_tpu_torch DeepLab state_dict."""
    out: Dict[str, torch.Tensor] = {}
    bn_modules = set()
    for collection in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(collection, {})):
            arr = np.asarray(value, dtype=np.float32)
            leaf = path[-1]
            module = _module_name(path[:-1])
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
    kernel does."""
    if isinstance(scales, str):
        scales = json.loads(scales)
    out = {}
    for path, value in scales.items():
        key = tuple(path.split("/")) if isinstance(path, str) else tuple(path)
        out[_module_name(key)] = float(value)
    return out
