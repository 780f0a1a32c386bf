"""The seen-class train step: `make_train_step` on DeepLabv3+ with
`SegOptimizer` (SGD, poly schedule, two LR groups), closed loop over a
pool of distinct batches already on the card (the loader bypassed).

Set-up builds the one model and optimizer, drives them through the
window's own call on batches 0-2 of the pool and records the three
losses, the first gradient (the momentum buffer after step 1 less the
weight decay of the initial weights) and the change of every parameter
after step 3; the window then continues from that state.  `check`
frees the program and runs the reference's three steps from the same
seed.
"""

from __future__ import annotations

import contextlib

import torch

from benchmark import inputs
from benchmark.loops import common
from benchmark.reference import compare, lowp
from benchmark.reference import train as ref_train

ENTRY = "zs3_tpu_torch.train.seen.make_train_step"
REPORTS = ("train_images_per_s", "train_step_p95_ms")
RECORDED = 3  # the steps the reference follows


class Loop:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from zs3_tpu_torch.core.config import Config, OptimConfig
        from zs3_tpu_torch.train.seen import make_train_step
        from zs3_tpu_torch.train.state import SegOptimizer
        from zs3_tpu_torch.utils.losses import build_seg_loss

        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.images_per_step = traffic["batch"]
        self.forward_passes = 3  # forward and backward: 3x the forward's FLOPs
        self.model = common.program_model(config, seed, device)
        cfg = Config(optim=OptimConfig(**config["optim"]))
        self.optimizer = SegOptimizer(self.model, cfg, traffic["schedule_steps"])
        self.train_step = make_train_step(build_seg_loss("ce", inputs.IGNORE), "full",
                                          seed=seed)
        self.pool = inputs.make_batches(traffic, config["model"]["num_classes"],
                                        common.exclude(config, traffic), seed, device)
        self.calls = 0
        self.readings = self.first_steps()
        for _ in range(traffic["warmup_steps"]):
            self.step()

    def step(self):
        out = self.train_step(self.model, self.optimizer,
                              self.pool[self.calls % len(self.pool)])
        self.calls += 1
        return out

    def first_steps(self):
        params = [p for _, p in self.model.named_parameters()]
        names = [n for n, _ in self.model.named_parameters()]
        wd = self.config["optim"]["weight_decay"]
        with torch.no_grad():
            p0 = [p.detach().clone() for p in params]
        losses = []
        for k in range(RECORDED):
            losses.append(self.step()["loss"].detach())
            if k == 0:
                with torch.no_grad():  # no buffer: the optimizer got no gradient
                    state = self.optimizer.sgd.state
                    bufs = [state[p]["momentum_buffer"] if "momentum_buffer" in state[p]
                            else p0_wd for p, p0_wd in zip(params, torch._foreach_mul(p0, wd))]
                    grad = torch.stack(torch._foreach_norm(
                        torch._foreach_sub(bufs, torch._foreach_mul(p0, wd))))
        with torch.no_grad():
            change = torch.stack(torch._foreach_norm(torch._foreach_sub(params, p0)))
        return names, torch.stack(losses), grad, change

    def program_readings(self) -> dict:
        """The recorded steps' readings on the host, the program freed."""
        names, losses, grad, change = self.readings
        prog = {"loss": losses.tolist(), "grad": dict(zip(names, grad.tolist())),
                "change": dict(zip(names, change.tolist()))}
        del self.model, self.optimizer, self.train_step, self.pool, self.readings
        common.free_card()
        return prog

    def check(self) -> dict:
        prog = self.program_readings()
        return compare_readings(prog, reference(self.config, self.traffic, self.seed, self.device))


def reference(config: dict, traffic: dict, seed: int, device, fp8: bool = False) -> dict:
    """The reference's readings of the recorded steps from `seed` (with
    `fp8`, every operation of its forward and backward in fp8: the
    control, reference/lowp.py)."""
    with common.tf32_off():
        model = common.reference_model(config, seed, device)
        batches = inputs.make_batches(traffic, config["model"]["num_classes"],
                                      common.exclude(config, traffic), seed, device)[:RECORDED]
        ref = ref_train.train_steps(model, batches, seed, config["optim"],
                                    traffic["schedule_steps"], RECORDED,
                                    lowp.fp8_everywhere if fp8 else contextlib.nullcontext)
    del model, batches
    common.free_card()
    return ref


def compare_readings(prog: dict, ref: dict) -> dict:
    keep = compare.kept_leaves(ref["grad"])
    return {
        "loss_gap": compare.worst_step(prog["loss"], ref["loss"]),
        "loss1_gap": compare.worst_step(prog["loss"][:1], ref["loss"][:1]),
        "grad_gap": compare.worst_leaf(prog["grad"], ref["grad"], keep),
        "change_gap": compare.worst_leaf(prog["change"], ref["change"], keep),
        "grad_median_gap": compare.median_leaf(prog["grad"], ref["grad"], keep),
        "change_median_gap": compare.median_leaf(prog["change"], ref["change"], keep),
    }
