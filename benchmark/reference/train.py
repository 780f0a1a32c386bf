"""The plain reference of the seen train step: the first steps of
DeepLabv3+ under cross-entropy and SGD, in f32 with TF32 off.

It re-derives from the seed what the program derived: the dropout
masks of step k come from a torch.Generator seeded by
SeedSequence((seed, k)), the rule the port states for its train step
(`train/seen.py::step_generator`), and each step's learning rate from
the poly schedule.  The update is torch.optim.SGD's arithmetic written
out: d = g + wd p; buf = d at the first step, momentum buf + d after;
p -= lr buf, with the ASPP, decoder and classifier at head_lr_mult times
the backbone's rate.  Imports nothing of the program.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

IGNORE = 255


def step_generator(seed: int, step: int, device) -> torch.Generator:
    state = np.random.SeedSequence((seed, step)).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def poly_lr(base: float, step: int, total: int, power: float) -> float:
    return base * (1 - min(max(step, 0), total) / total) ** power


def train_steps(model, batches: List[Dict[str, torch.Tensor]], seed: int, optim: dict,
                total_steps: int, steps: int = 3,
                compute=contextlib.nullcontext) -> Dict[str, object]:
    """`steps` steps of `model` (in train mode, its backbone's blocks
    recomputed in the backward) on batches[0..steps-1]:
    {"loss": [per step], "grad": {leaf: |g| at step 1}, "change": {leaf:
    |p_steps - p_0|}}.  Each forward and backward runs inside `compute()`
    (the update outside it)."""
    params = dict(model.named_parameters())
    p0 = {n: p.detach().clone() for n, p in params.items()}
    bufs: Dict[str, torch.Tensor] = {}
    losses, first_grad = [], {}
    model.train()
    model.backbone.save_memory = True
    for k in range(steps):
        batch = batches[k]
        model.dropout_generator = step_generator(seed, k, batch["image"].device)
        with compute():
            logits = model(batch["image"].permute(0, 3, 1, 2))
            loss = F.cross_entropy(logits, batch["label"].long(), ignore_index=IGNORE)
            grads = torch.autograd.grad(loss, list(params.values()))
        lr = poly_lr(optim["lr"], k, total_steps, optim["poly_power"])
        with torch.no_grad():
            for (name, p), g in zip(params.items(), grads):
                if k == 0:
                    first_grad[name] = float(g.norm())
                d = g + optim["weight_decay"] * p
                bufs[name] = d if k == 0 else optim["momentum"] * bufs[name] + d
                mult = 1.0 if name.startswith("backbone.") else optim["head_lr_mult"]
                p -= lr * mult * bufs[name]
        losses.append(float(loss.detach()))
        del logits, loss, grads
    change = {n: float((p.detach() - p0[n]).norm()) for n, p in params.items()}
    return {"loss": losses, "grad": first_grad, "change": change}
