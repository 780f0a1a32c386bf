"""On the card, at each cell's own size and on one seed: the program as
configured passes the check, and half of the batch left out and the
control (the reference with every operation in fp8, reference/lowp.py)
each fail it.  Run there with `python3 -m pytest benchmark/tests -m card`."""

import pytest

from benchmark import control, spec

BENCH = spec.Spec()
SEED = 2**31 + 424242


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH.data["workloads"]])
def test_the_program_passes_and_a_half_batch_and_the_control_fail(card, cell):
    entry = BENCH.cell(cell)
    config = BENCH.config(entry["config"])
    traffic = BENCH.traffic(entry["traffic"])
    kind = spec.loop(traffic["loop"])
    limits = BENCH.limits(cell)
    variants = ["sound", "half_batch", "fp8_reference"]
    got = {v: control.readings(kind, config, traffic, SEED, card, v) for v in variants}
    ref = kind.reference(config, traffic, SEED, card)
    numbers = {v: kind.compare_readings(got[v], ref) for v in variants}
    assert all(numbers["sound"][k] <= limit for k, limit in limits.items()), numbers["sound"]
    for v in variants[1:]:
        assert any(numbers[v][k] > limit for k, limit in limits.items()), (v, numbers[v])
