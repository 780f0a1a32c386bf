"""LR schedules as pure functions of the step (port of zs3_tpu.utils.schedules).

`build_schedule(mode, base_lr, total_steps, warmup_steps, poly_power)`
returns step -> learning rate with optax's formulas, which zs3_tpu's
schedules are made of: poly (`polynomial_schedule`, its count clipped
to [0, transition_steps]), cos (`cosine_decay_schedule`, count capped at
decay_steps), step (one 0.1x drop from floor(2/3 total) on, as
`piecewise_constant_schedule` does at its boundary) and const; with
warmup, a linear ramp from 0 joined at `warmup_steps`, after which the
main schedule sees step - warmup_steps (`join_schedules`).  The step is
the optimizer's count before its increment, as optax evaluates it.
Values are Python floats.
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def _polynomial(init: float, end: float, power: float, transition_steps: int) -> Schedule:
    if transition_steps <= 0:
        return lambda count: init

    def schedule(count: int) -> float:
        count = min(max(count, 0), transition_steps)
        frac = 1 - count / transition_steps
        return (init - end) * frac**power + end

    return schedule


def build_schedule(
    mode: str,
    base_lr: float,
    total_steps: int,
    warmup_steps: int = 0,
    poly_power: float = 0.9,
) -> Schedule:
    total_steps = max(int(total_steps), 1)
    if mode == "poly":
        main = _polynomial(base_lr, 0.0, poly_power, max(total_steps - warmup_steps, 1))
    elif mode == "cos":
        decay_steps = float(max(total_steps - warmup_steps, 1))

        def main(count: int) -> float:
            count = min(count, decay_steps)
            return base_lr * (0.5 * (1 + math.cos(math.pi * count / decay_steps)))

    elif mode == "step":
        boundary = int(total_steps * 2 / 3)

        def main(count: int) -> float:
            return base_lr if count < boundary else 0.1 * base_lr

    elif mode == "const":

        def main(count: int) -> float:
            return base_lr

    else:
        raise ValueError(f"unknown schedule {mode!r}")

    if warmup_steps > 0:
        warmup = _polynomial(0.0, base_lr, 1.0, warmup_steps)
        return lambda step: warmup(step) if step < warmup_steps else main(step - warmup_steps)
    return main
