"""The reference put in the program's place one precision below the
configuration's bf16: every operation of the reference computed in fp8.
Each floating operand an operation reads (weights included) and each
result it makes is rounded to fp8 under a per-tensor scale (its largest
magnitude at the format's largest value): e4m3 in the forward, e5m2 in
the backward (where autograd runs a node, recomputed blocks included);
the arithmetic within one operation stays f32, as on fp8 tensor cores.
Views, and the operands an operation writes into (in-place results,
running statistics), are left as they are.
A control for the train check: the step a later change might take from
bf16 (python3 -m benchmark.control --variants fp8_reference)."""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2


def to_fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to `dtype` under a per-tensor scale, back in x's dtype."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (x / scale).to(dtype).to(x.dtype) * scale


def _rounder(dtype):
    def round_(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point() and x.numel() > 0:
            return to_fp8(x, dtype)
        return x
    return round_


class fp8_everywhere(TorchDispatchMode):
    """Inside, every operation of torch runs on and makes fp8 values (see
    the module's docstring)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        schema = func._schema
        if any(r.alias_info is not None and not r.alias_info.is_write for r in schema.returns):
            return func(*args, **kwargs)  # a view
        backward = torch._C._current_autograd_node() is not None
        round_ = _rounder(E5M2 if backward else E4M3)
        written = {a.name for a in schema.arguments
                   if a.alias_info is not None and a.alias_info.is_write}
        names = [a.name for a in schema.arguments]
        args = [a if i < len(names) and names[i] in written else tree_map(round_, a)
                for i, a in enumerate(args)]
        kwargs = {k: v if k in written else tree_map(round_, v) for k, v in kwargs.items()}
        out = func(*args, **kwargs)
        if len(schema.returns) <= 1:
            fresh = not schema.returns or schema.returns[0].alias_info is None
            return tree_map(round_, out) if fresh else out
        return type(out)(o if r.alias_info is not None else tree_map(round_, o)
                         for o, r in zip(out, schema.returns))
