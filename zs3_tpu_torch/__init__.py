"""zs3_tpu_torch — the PyTorch/CUDA port of zs3_tpu for NVIDIA Hopper.

Mirrors zs3_tpu's module layout so each module has a named counterpart.
The port imports torch, numpy and PIL only: never jax, flax or any
module of zs3_tpu.  Public functions keep zs3_tpu's NHWC layout; inside,
tensors are permuted to NCHW in torch.channels_last memory format so
cuDNN runs its NHWC kernels without copies.

Entry points default to ``device="cuda"`` and raise when no GPU is
present; only an explicit ``device="cpu"`` runs the plain PyTorch path
on the CPU.
"""

__version__ = "0.1.0"
