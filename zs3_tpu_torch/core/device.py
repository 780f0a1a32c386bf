"""Device selection (the GPU unless the caller asks for the CPU), and
caches of constant tensors that stay right across a trace."""

from __future__ import annotations

import functools
from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """torch.device for `device`, refusing CUDA when no GPU is present.

    There is no silent fallback: code that defaults to the GPU fails on
    a GPU-less host unless the caller passes ``device="cpu"`` itself.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev


def device_constant_cache(maxsize: int):
    """functools.lru_cache for a function that builds constant tensors on
    a device, bypassed while torch.export or torch.compile traces.

    Under a trace the function's tensors are fake ones (shapes without
    data) that belong to that trace: kept in the cache, every later eager
    call in the process would compute on them.  So a traced call builds
    its tensors anew, and the trace records their values as constants of
    the program; the cache holds only tensors made outside a trace."""

    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def call(*args):
            if torch.compiler.is_compiling():
                return fn(*args)
            return cached(*args)

        call.cache_info = cached.cache_info
        call.cache_clear = cached.cache_clear
        return call

    return wrap
