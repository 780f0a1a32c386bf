"""Gaussian-kernel Maximum Mean Discrepancy: the plain oracle
(port of zs3_tpu.ops.mmd).

MMD between generated and real per-class pixel features with a
multi-bandwidth Gaussian kernel, sigma in {2,5,10,20,40,80} (reference:
zs3/modeling/gmmn.py GMMNLoss).  Plain PyTorch with the (N, M) matrices
materialised: the plain versions' building blocks and the autodiff
reference of the tests and of chip_smoke.py; the training step does not
call `mmd_loss` or `batched_mmd_loss`.  The hand-written kernels K2/K3 that keep the
matrices out of device memory are in zs3_tpu_torch.ops.mmd_kernels.

Every function takes a leading batch of classes where it makes sense,
and explicit validity masks, so ragged per-class pixel sets are fixed
budgets plus weights.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

DEFAULT_SIGMAS: Tuple[float, ...] = (2.0, 5.0, 10.0, 20.0, 40.0, 80.0)


def pairwise_sq_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(..., N, D), (..., M, D) -> (..., N, M) squared euclidean distances,
    as |x|^2 + |y|^2 - 2 x.y clamped at zero against round-off."""
    x = x.float()
    y = y.float()
    xx = (x * x).sum(-1)
    yy = (y * y).sum(-1)
    xy = x @ y.transpose(-1, -2)
    return torch.clamp(xx[..., :, None] + yy[..., None, :] - 2.0 * xy, min=0.0)


def _kernel_sum(
    x: torch.Tensor,
    y: torch.Tensor,
    wx: torch.Tensor,
    wy: torch.Tensor,
    sigmas: Sequence[float],
) -> torch.Tensor:
    """sum_ij wx_i wy_j sum_s exp(-d2_ij / (2 sigma_s)) over the last two
    axes: (..., N, D), (..., M, D), (..., N), (..., M) -> (...)."""
    d2 = pairwise_sq_dists(x, y)
    k = sum(torch.exp(-d2 / (2.0 * float(s))) for s in sigmas)
    return torch.einsum("...n,...nm,...m->...", wx, k, wy)


def resolve_weights(
    fake: torch.Tensor,
    real: torch.Tensor,
    fake_mask: Optional[torch.Tensor],
    real_mask: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 validity weights over the row axis (all ones when a mask is None)."""
    wf = (
        fake.new_ones(fake.shape[:-1], dtype=torch.float32)
        if fake_mask is None
        else fake_mask.float()
    )
    wr = (
        real.new_ones(real.shape[:-1], dtype=torch.float32)
        if real_mask is None
        else real_mask.float()
    )
    return wf, wr


def assemble_sqrt_mmd(
    k_ff: torch.Tensor, k_rr: torch.Tensor, k_fr: torch.Tensor,
    nf: torch.Tensor, nr: torch.Tensor,
) -> torch.Tensor:
    """sqrt-MMD from the three weighted kernel sums: guarded denominators,
    a 1e-12 floor under the sqrt, and 0 where either side is empty.
    Shared by the oracle and the kernel path, as in zs3_tpu."""
    safe_nf = torch.clamp(nf, min=1.0)
    safe_nr = torch.clamp(nr, min=1.0)
    mmd2 = (
        k_ff / (safe_nf * safe_nf)
        + k_rr / (safe_nr * safe_nr)
        - 2.0 * k_fr / (safe_nf * safe_nr)
    )
    both = (nf > 0) & (nr > 0)
    return torch.where(both, torch.sqrt(torch.clamp(mmd2, min=1e-12)), 0.0)


def mean_over_present_classes(
    per_class: torch.Tensor, fake_mask: torch.Tensor, real_mask: torch.Tensor
) -> torch.Tensor:
    """Mean of per-class losses over classes with both sides non-empty."""
    present = ((fake_mask.sum(-1) > 0) & (real_mask.sum(-1) > 0)).float()
    denom = torch.clamp(present.sum(), min=1.0)
    return (per_class * present).sum() / denom


def mmd_loss(
    fake: torch.Tensor,
    real: torch.Tensor,
    fake_mask: Optional[torch.Tensor] = None,
    real_mask: Optional[torch.Tensor] = None,
    sigmas: Sequence[float] = DEFAULT_SIGMAS,
) -> torch.Tensor:
    """Biased sqrt-MMD between fake (N, D) and real (M, D) features; an
    all-zero mask gives 0."""
    if fake.ndim != 2 or real.ndim != 2 or fake.shape[1] != real.shape[1]:
        raise ValueError(
            f"mmd_loss expects (N, D) and (M, D) with equal D; got "
            f"{tuple(fake.shape)} vs {tuple(real.shape)}"
        )
    return _sqrt_mmd(fake, real, fake_mask, real_mask, sigmas)


def _sqrt_mmd(fake, real, fake_mask, real_mask, sigmas) -> torch.Tensor:
    fake = fake.float()
    real = real.float()
    wf, wr = resolve_weights(fake, real, fake_mask, real_mask)
    k_ff = _kernel_sum(fake, fake, wf, wf, sigmas)
    k_rr = _kernel_sum(real, real, wr, wr, sigmas)
    k_fr = _kernel_sum(fake, real, wf, wr, sigmas)
    return assemble_sqrt_mmd(k_ff, k_rr, k_fr, wf.sum(-1), wr.sum(-1))


def batched_mmd_loss(
    fake: torch.Tensor,
    real: torch.Tensor,
    fake_mask: torch.Tensor,
    real_mask: torch.Tensor,
    sigmas: Sequence[float] = DEFAULT_SIGMAS,
) -> torch.Tensor:
    """Mean sqrt-MMD over a leading class axis, (C, N, D) vs (C, M, D),
    over the classes that have both real and fake pixels."""
    per_class = _sqrt_mmd(fake, real, fake_mask, real_mask, sigmas)
    return mean_over_present_classes(per_class, fake_mask, real_mask)
