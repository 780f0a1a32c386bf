"""GMMN generator (port of zs3_tpu.models.gmmn).

An MLP mapping concat(class embedding, noise) to a synthetic 256-d pixel
feature (reference: zs3/modeling/gmmn.py GMMNnetwork), trained against
real features with the MMD loss.  Layers are `nn.Linear` named
``hidden0..`` and ``out``, so zs3_tpu's Dense params carry over by name
(zs3_tpu_torch.utils.convert.gmmn_state_dict_from_flax).  The
graph-context variant comes with the ZS5/graph slice.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from zs3_tpu_torch.core.config import GMMNConfig


class GMMNGenerator(nn.Module):
    def __init__(
        self,
        noise_dim: int = 300,
        embed_dim: int = 300,
        hidden_dim: int = 256,
        feature_dim: int = 256,
        num_hidden: int = 1,
        dropout_rate: float = 0.0,
        leaky_slope: float = 0.2,
    ):
        super().__init__()
        self.num_hidden = num_hidden
        self.leaky_slope = leaky_slope
        width = embed_dim + noise_dim
        for i in range(num_hidden):
            self.add_module(f"hidden{i}", nn.Linear(width, hidden_dim))
            width = hidden_dim
        self.out = nn.Linear(width, feature_dim)
        self.dropout = nn.Dropout(dropout_rate) if dropout_rate > 0 else None

    def forward(
        self, embedding: torch.Tensor, noise: torch.Tensor, deterministic: bool = True
    ) -> torch.Tensor:
        """(..., embed_dim), (..., noise_dim) -> (..., feature_dim), f32."""
        x = torch.cat([embedding.float(), noise.float()], dim=-1)
        for i in range(self.num_hidden):
            x = F.leaky_relu(getattr(self, f"hidden{i}")(x), self.leaky_slope)
            if self.dropout is not None and not deterministic:
                x = self.dropout(x)
        # Real decoder features are post-ReLU; match their support.
        return F.relu(self.out(x))


def build_gmmn(cfg: GMMNConfig) -> GMMNGenerator:
    """The generator for `cfg` with default-initialised weights (see
    init_gmmn for the seeded init)."""
    if cfg.graph_context:
        raise NotImplementedError(
            "graph_context=True needs GraphContextGMMN, which comes with the "
            "ZS5/graph slice"
        )
    return GMMNGenerator(
        noise_dim=cfg.noise_dim,
        embed_dim=cfg.embed_dim,
        hidden_dim=cfg.hidden_dim,
        feature_dim=cfg.feature_dim,
        num_hidden=cfg.num_hidden,
        dropout_rate=cfg.dropout_rate,
        leaky_slope=cfg.leaky_slope,
    )


@torch.no_grad()
def init_gmmn(module: nn.Module, seed: int) -> nn.Module:
    """Seeded init in place with flax Dense's initializers: lecun-normal
    weights (truncated at 2 std), zero biases.  torch draws other numbers
    than jax.random from the same seed."""
    gen = torch.Generator().manual_seed(seed)
    for layer in module.modules():
        if isinstance(layer, nn.Linear):
            std = math.sqrt(1.0 / layer.in_features) / 0.87962566103423978
            nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std, 2 * std, generator=gen)
            layer.bias.zero_()
    return module
