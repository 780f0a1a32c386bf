"""Device selection: the GPU unless the caller asks for the CPU."""

from __future__ import annotations

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
