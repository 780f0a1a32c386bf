"""The train step's spans (utils/profiling.py::span, recording): what one
`make_train_step` call records, that the records leave the step's
arithmetic alone, and that a torch.profiler trace holds them.  A DeepLab
with a (1, 1, 1, 1) ResNet trunk at 33x33 in f32 on the CPU, dropout on."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from zs3_tpu_torch.core.config import Config
from zs3_tpu_torch.models.deeplab import DeepLab, init_deeplab
from zs3_tpu_torch.train.seen import make_train_step
from zs3_tpu_torch.train.state import SegOptimizer
from zs3_tpu_torch.utils import losses
from zs3_tpu_torch.utils.profiling import recording, span

from tests.torch_port_threads import torch_one_thread  # noqa: F401 (autouse)

STEP = "zs3.train.step"
PHASES = ("zs3.train.prepare", "zs3.train.forward", "zs3.train.backward",
          "zs3.train.optimizer")


def _setup(grad_accum=1):
    model = init_deeplab(DeepLab(backbone="resnet50", num_classes=5, layers=(1, 1, 1, 1)), 0)
    optimizer = SegOptimizer(model, Config(), 10)
    step = make_train_step(losses.build_seg_loss("ce", 255), grad_accum=grad_accum, seed=3)
    rng = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(rng.standard_normal((2, 33, 33, 3), np.float32)),
             "label": torch.from_numpy(rng.integers(0, 5, (2, 33, 33), np.int32))}
    return model, optimizer, step, batch


def test_one_step_records_the_step_and_its_four_phases():
    model, optimizer, step, batch = _setup()
    with recording() as records:
        step(model, optimizer, batch)
    assert [r[0] for r in records] == [*PHASES, STEP]  # each closes before its parent
    (_, parent, call, start, end), = [r for r in records if r[0] == STEP]
    assert parent is None and start < end
    for name, parent, child_call, child_start, child_end in records[:-1]:
        assert parent == STEP and child_call == call
        assert start <= child_start <= child_end <= end
    starts = [r[3] for r in records[:-1]]
    assert starts == sorted(starts)


def test_microbatches_share_the_call_id_of_their_step():
    model, optimizer, step, batch = _setup(grad_accum=2)
    with recording() as records:
        step(model, optimizer, batch)
        step(model, optimizer, batch)
    names = [r[0] for r in records]
    assert names == ["zs3.train.prepare", "zs3.train.forward", "zs3.train.backward",
                     "zs3.train.forward", "zs3.train.backward", "zs3.train.optimizer",
                     STEP] * 2
    first, second = {r[2] for r in records[:7]}, {r[2] for r in records[7:]}
    assert len(first) == len(second) == 1 and first != second


def test_nothing_is_recorded_with_the_recorder_off():
    model, optimizer, step, batch = _setup()
    with recording() as records:
        pass
    step(model, optimizer, batch)
    assert records == []
    assert span("a") is span("b")
    with span("a"):
        pass


def test_recording_leaves_the_step_bit_equal():
    runs = []
    for on in (False, True):
        model, optimizer, step, batch = _setup()
        if on:
            with recording() as records:
                out = [step(model, optimizer, batch)["loss"] for _ in range(2)]
            assert len(records) == 10
        else:
            out = [step(model, optimizer, batch)["loss"] for _ in range(2)]
        runs.append((out, [p.detach().clone() for p in model.parameters()]))
    (loss_off, params_off), (loss_on, params_on) = runs
    assert all(torch.equal(a, b) for a, b in zip(loss_off, loss_on))
    assert all(torch.equal(a, b) for a, b in zip(params_off, params_on))


@pytest.mark.parametrize("recorded", [False, True])
def test_the_profiler_holds_the_spans_as_host_ranges(recorded):
    model, optimizer, step, batch = _setup()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if recorded:
            with recording() as records:
                step(model, optimizer, batch)
            assert len(records) == 5
        else:
            step(model, optimizer, batch)
    names = {e.name for e in prof.events()}
    assert {STEP, *PHASES} <= names
    step_event = next(e for e in prof.events() if e.name == STEP)
    backward = next(e for e in prof.events() if e.name == "zs3.train.backward")
    assert step_event.time_range.start <= backward.time_range.start
    assert backward.time_range.end <= step_event.time_range.end
