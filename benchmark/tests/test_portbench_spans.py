"""The span readings (benchmark/spans.py, benchmark/spanrun.py): the
attribution of device events to the span their launch ran in, on a
hand-made profile; the host readings of the program's records; and one
run of the tiny cell on the CPU."""

import time

import pytest
from torch.autograd import DeviceType

from benchmark import spans, spanrun, spec
from benchmark.tests import tiny

SEED = 2**31 + 987654321
US = 1000  # ns


class Event:
    """The methods of a kineto event that spans.device_phases calls."""

    def __init__(self, name, start, end, device=False, corr=0, linked=0, annotation=False):
        self._name, self._start, self._end = name, start * US, end * US
        self._device, self._corr, self._linked = device, corr, linked
        self._annotation = annotation

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def device_type(self):
        return DeviceType.CUDA if self._device else DeviceType.CPU

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked

    def is_user_annotation(self):
        return self._annotation


def launch(corr, at):
    return Event("cudaLaunchKernel", at, at + 2, corr=corr, linked=100 + corr)


def kernel(corr, start, end):
    return Event(f"kernel{corr}", start, end, device=True, corr=corr, linked=100 + corr)


EVENTS = [
    Event("zs3.train.step", 0, 1000, corr=1),
    Event("zs3.train.prepare", 10, 100, corr=2),
    Event("zs3.train.forward", 100, 400, corr=3),
    Event("aten::conv2d", 120, 200, corr=7),  # an op: its own id is no launch's
    Event("zs3.train.backward", 400, 800, corr=4),
    Event("zs3.train.optimizer", 800, 950, corr=5),
    launch(7, 150),  # forward, main thread
    launch(8, 500),  # backward, autograd's device thread: no span on that thread
    launch(9, 900),  # optimizer
    launch(11, 960),  # the step's own time (the loss's divide)
    launch(10, 1200),  # between steps
    kernel(7, 300, 400),
    kernel(8, 600, 800),
    kernel(9, 950, 1000),
    kernel(11, 1100, 1120),
    kernel(10, 1300, 1310),
    kernel(12, 1400, 1405),  # its launch not in the window
    Event("zs3.train.forward", 300, 700, device=True, annotation=True),  # the range on the card
]


def test_device_events_go_to_the_span_of_their_launch():
    found = spans.device_phases(EVENTS)
    assert found["busy_s"] == pytest.approx(385e-6)
    assert found["device_s"] == pytest.approx({
        "zs3.train.forward": 100e-6, "zs3.train.backward": 200e-6,
        "zs3.train.optimizer": 50e-6, "zs3.train.step": 20e-6, spans.OUTSIDE: 15e-6})
    assert found["idle_s"] == pytest.approx({
        "zs3.train.backward": 200e-6, "zs3.train.optimizer": 150e-6,
        spans.OUTSIDE: 100e-6 + 180e-6 + 90e-6})


def test_gaps_under_the_least_are_not_idle():
    device = [(0, 10 * US, 1), (14 * US, 20 * US, 2), (30 * US, 40 * US, 3)]
    assert spans.idle_by_span([(0, 50 * US, "zs3.train.step")], device) == pytest.approx(
        {"zs3.train.step": 10e-6})


def test_host_readings_of_the_records():
    records = [  # (name, parent, call, start, end): two calls of grad_accum 2
        ("zs3.train.prepare", "zs3.train.step", 1, 0, 1_000_000),
        ("zs3.train.forward", "zs3.train.step", 1, 1_000_000, 3_000_000),
        ("zs3.train.forward", "zs3.train.step", 1, 4_000_000, 6_000_000),
        ("zs3.train.step", None, 1, 0, 8_000_000),
        ("zs3.train.forward", "zs3.train.step", 2, 9_000_000, 10_000_000),
        ("zs3.train.step", None, 2, 8_500_000, 12_500_000),
    ]
    assert spans.host_ms(records) == pytest.approx(
        {"zs3.train.prepare": 1.0, "zs3.train.forward": 2.5, "zs3.train.step": 6.0})
    assert spans.first_step_ms(records) == pytest.approx(8.0)
    assert spans.first_step_ms(records[:3]) is None


def test_each_metric_is_left_out_without_its_reading():
    host = {f"zs3.train.{p}": 1.0 for p in spans.HOST_PHASES}
    device = {"zs3.train.forward": 0.2, "zs3.train.backward": 0.4}
    found = spans.metrics(host, device, 4, 9.0)
    assert found == {"prepare_host_ms.train": 1.0, "forward_host_ms.train": 1.0,
                     "backward_host_ms.train": 1.0, "optimizer_host_ms.train": 1.0,
                     "forward_device_ms.train": 50.0, "backward_device_ms.train": 100.0,
                     "optimizer_device_ms.train": 0.0, "first_step_host_ms.train": 9.0}
    assert spans.metrics({}, {}, 4, None) == {}
    assert set(spans.metrics({"zs3.train.forward": 1.0}, {}, 4, None)) == {
        "forward_host_ms.train"}


def test_a_run_of_the_tiny_cell_on_the_cpu(tmp_path):
    """No device events on the CPU: the host phases and the first step."""
    root = spec.Spec(tiny.make_root(tmp_path))
    t0 = time.perf_counter()
    result = spanrun.run_spans(root, "tiny-r101-train", SEED, "cpu")
    assert set(result["metrics"]) == {"prepare_host_ms.train", "forward_host_ms.train",
                                      "backward_host_ms.train", "optimizer_host_ms.train",
                                      "first_step_host_ms.train"}
    assert all(v > 0 for v in result["metrics"].values())
    sums = result["sums"]
    assert sums["host_phases_ms"] <= 1e3 * (time.perf_counter() - t0)
    assert 0 < sums["host_ms"]["zs3.train.forward"] < sums["host_ms"]["zs3.train.step"]
    assert sums["busy_ms"] == 0 and sums["device_ms"] == {} and sums["dispatch_ms"] is None
