"""Faults planted in the program, for the control readings (control.py)
and the tests that see `correct` come out false:

  frozen       a train step that leaves the parameters unchanged (the
               seen step's optimizer counts the step and applies nothing);
  half_batch   half of the batch left out, the mean taken over the rest
               (the train loss's forward).
"""

from __future__ import annotations

import contextlib

FAULTS = ("frozen", "half_batch")


@contextlib.contextmanager
def planted(fault: str):
    from zs3_tpu_torch.train import seen, state

    saved = {}

    def patch(owner, name, value):
        saved[(owner, name)] = getattr(owner, name)
        setattr(owner, name, value)

    if fault == "frozen":
        def apply(self):
            self.step += 1

        patch(state.SegOptimizer, "apply", apply)
    elif fault == "half_batch":
        forward_for_loss = seen.forward_for_loss

        def half_forward(model, images, labels, loss_at="full"):
            n = images.shape[0] // 2
            return forward_for_loss(model, images[:n], labels[:n], loss_at)

        patch(seen, "forward_for_loss", half_forward)
    else:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
    try:
        yield
    finally:
        for (owner, name), value in saved.items():
            setattr(owner, name, value)
