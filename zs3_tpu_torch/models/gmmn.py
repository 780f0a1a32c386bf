"""GMMN generator (port of zs3_tpu.models.gmmn).

An MLP mapping concat(class embedding, noise) to a synthetic 256-d pixel
feature (reference: zs3/modeling/gmmn.py GMMNnetwork), trained against
real features with the MMD loss.  Layers are `nn.Linear` named
``hidden0..`` and ``out``, so zs3_tpu's Dense params carry over by name
(zs3_tpu_torch.utils.convert.gmmn_state_dict_from_flax).

GraphContextGMMN is the spatial-context-prior variant (arXiv:1906.00817
§3.3): generation is also conditioned on the class embeddings of up to
K neighbouring regions, embedded by ``graph_embed`` and averaged under a
validity mask.
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
        return self.mlp(torch.cat([embedding.float(), noise.float()], dim=-1), deterministic)

    def mlp(self, x: torch.Tensor, deterministic: bool) -> torch.Tensor:
        for i in range(self.num_hidden):
            x = F.leaky_relu(getattr(self, f"hidden{i}")(x), self.leaky_slope)
            if self.dropout is not None and not deterministic:
                x = self.dropout(x)
        # Real decoder features are post-ReLU; match their support.
        return F.relu(self.out(x))


class GraphContextGMMN(GMMNGenerator):
    """GMMNGenerator conditioned on the neighbouring regions' classes.

    `neighbors` (..., K, embed_dim) holds up to K neighbour class
    embeddings and `neighbor_mask` (..., K) which of them are real (the
    fixed-size encoding of a variable-degree region graph).  Each
    neighbour goes through ``graph_embed`` and a leaky ReLU, a masked mean
    aggregates them (an empty list gives a zero context), and the context
    joins (embedding, noise) at the MLP's input.
    """

    def __init__(
        self,
        noise_dim: int = 300,
        embed_dim: int = 300,
        hidden_dim: int = 256,
        feature_dim: int = 256,
        context_dim: int = 256,
        num_hidden: int = 1,
        dropout_rate: float = 0.0,
        leaky_slope: float = 0.2,
    ):
        # The MLP's input is (embedding, noise, context).
        super().__init__(noise_dim + context_dim, embed_dim, hidden_dim, feature_dim,
                         num_hidden, dropout_rate, leaky_slope)
        self.graph_embed = nn.Linear(embed_dim, context_dim)

    def forward(
        self,
        embedding: torch.Tensor,
        noise: torch.Tensor,
        neighbors: torch.Tensor,
        neighbor_mask: torch.Tensor,
        deterministic: bool = True,
    ) -> torch.Tensor:
        h = F.leaky_relu(self.graph_embed(neighbors.float()), self.leaky_slope)
        w = neighbor_mask.float()[..., None]
        context = (h * w).sum(-2) / torch.clamp(w.sum(-2), min=1.0)
        x = torch.cat([embedding.float(), noise.float(), context], dim=-1)
        return self.mlp(x, deterministic)


def build_gmmn(cfg: GMMNConfig) -> GMMNGenerator:
    """The plain or graph-context generator for `cfg` with
    default-initialised weights (see init_gmmn for the seeded init)."""
    common = dict(
        noise_dim=cfg.noise_dim,
        embed_dim=cfg.embed_dim,
        hidden_dim=cfg.hidden_dim,
        feature_dim=cfg.feature_dim,
        num_hidden=cfg.num_hidden,
        dropout_rate=cfg.dropout_rate,
        leaky_slope=cfg.leaky_slope,
    )
    if cfg.graph_context:
        return GraphContextGMMN(context_dim=cfg.graph_hidden_dim, **common)
    return GMMNGenerator(**common)


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
