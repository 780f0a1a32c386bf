"""The seen-class optimizer (port of zs3_tpu.train.state).

SGD over two parameter groups: ``backbone.*`` at 1x the scheduled LR and
everything else (ASPP, decoder, classifier) at ``head_lr_mult``x, as
zs3_tpu's optax.multi_transform labels ``encoder`` against the rest.
optax's ``add_decayed_weights(wd)`` followed by ``sgd(momentum,
nesterov)`` is torch's SGD with ``weight_decay=wd, dampening=0``; the
decay applies to every parameter, BN and biases included, as the
unmasked chain does.  Before each update every group's lr is set from
the schedule at the step count before its increment, as optax
evaluates it.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from zs3_tpu_torch.core.config import Config
from zs3_tpu_torch.utils.schedules import build_schedule


class SegOptimizer:
    """torch.optim.SGD with zs3_tpu's two LR groups and schedule; `step`
    counts the updates applied (the train state's step)."""

    def __init__(self, model: torch.nn.Module, cfg: Config, total_steps: int):
        optim = cfg.optim
        backbone, head = [], []
        for name, p in model.named_parameters():
            (backbone if name.startswith("backbone.") else head).append(p)
        self.schedule = build_schedule(
            optim.schedule, optim.lr, total_steps, optim.warmup_steps, optim.poly_power
        )
        self.sgd = torch.optim.SGD(
            [{"params": backbone, "lr_mult": 1.0},
             {"params": head, "lr_mult": optim.head_lr_mult}],
            lr=optim.lr, momentum=optim.momentum, dampening=0.0,
            weight_decay=optim.weight_decay, nesterov=optim.nesterov,
        )
        self.step = 0

    def lr(self) -> float:
        """The base (1x) learning rate of the next update."""
        return self.schedule(self.step)

    def zero_grad(self):
        self.sgd.zero_grad(set_to_none=True)

    def apply(self):
        """One update from the parameters' .grad, then step += 1."""
        lr = self.lr()
        for group in self.sgd.param_groups:
            group["lr"] = lr * group["lr_mult"]
        self.sgd.step()
        self.step += 1

    def state_dict(self) -> Dict[str, Any]:
        return {"sgd": self.sgd.state_dict(), "step": self.step}

    def load_state_dict(self, state: Dict[str, Any]):
        self.sgd.load_state_dict(state["sgd"])
        self.step = int(state["step"])
