"""The ResNeSt-101 configuration and its cell: their files load through
spec.Spec, the frozen FLOPs count again, the split-attention bytes count
is pinned on a tiny configuration, the two split-attention readers leave
their metrics out where no `splat_` kernel ran, and a tiny ResNeSt cell
runs through the harness on the CPU, correct against its reference."""

import json
import time

import pytest

from benchmark import counts, harness, spec
from benchmark.counts import splat
from benchmark.loops import train, train_gated
from benchmark.tests import tiny

BENCH = spec.Spec()
CELL = "resnest101-context-train-b24"
CONFIG = "deeplabv3plus-resnest101-os8-context"
SEED = 2**31 + 13579


def test_the_cell_and_its_files_load():
    entry = BENCH.cell(CELL)
    assert entry == {"name": CELL, "config": CONFIG, "traffic": "seen-train-b24-512",
                     "chips": 1, "why": entry["why"]}
    config = BENCH.config(CONFIG)
    assert config["reference"] == "benchmark.reference.resnest"
    m = config["model"]
    assert (m["backbone"], m["layers"], m["output_stride"], m["aspp_rates"]) == (
        "resnest101", [3, 4, 23, 3], 8, [12, 24, 36])
    assert (m["num_classes"], m["feature_dim"], m["low_level_dim"], m["compute_dtype"]) == (
        59, 256, 48, "bfloat16")
    assert config["unseen_classes"] == [19, 33] and config["crop_size"] == 512
    assert config["optim"]["lr"] == 0.01 and config["optim"]["head_lr_mult"] == 1.0
    assert config["reduced"] == [] and len(config["assumed"]) == 5
    traffic = BENCH.traffic(entry["traffic"])
    assert (traffic["loop"], traffic["batch"], traffic["crop"], traffic["schedule_steps"]) == (
        "train_gated", 24, 512, 106667)
    assert BENCH.limits(CELL)
    assert [m["name"] for m in BENCH.end_to_end(CELL)] == ["train_images_per_s", "setup_s"]
    per_layer = {m["name"] for m in BENCH.per_layer(CELL)}
    assert {"splat_device_ms.train", "splat_roofline.train", "mfu.train", "bn_device_ms.train",
            "launches.train", "dispatch_ms.train", "host_syncs.train",
            "idle_share.train"} == per_layer
    for cell in ("r101-voc-train-b48", "xception65-voc-train-b32"):
        assert not {"splat_device_ms.train", "splat_roofline.train"} & {
            m["name"] for m in BENCH.per_layer(cell)}


def test_the_frozen_flops_are_about_5_4e11_an_image():
    config = BENCH.config(CONFIG)
    frozen = counts.frozen(CONFIG)
    assert frozen["crop"] == 512
    assert counts.count_forward_flops(config, 512) == frozen["forward_flops"]
    assert round(frozen["forward_flops"] / 1e11, 1) == 5.4
    assert counts.forward_flops(CONFIG, 512) == frozen["forward_flops"]


def test_the_split_attention_bytes_on_a_tiny_configuration():
    """One block a stage at os 8, batch 2, crop 65 (stem: 33, then 17):
    u is (2, 17, 17, 128) and (2, 17, 17, 256) in stages 1 and 2's first
    block (before its pool), then (2, 9, 9, 512) and (2, 9, 9, 1024); bf16.
    All fit in L2: forward |u| + |out|, backward |dy| + |u| and |du|."""
    config = {"model": {"layers": [1, 1, 1, 1], "output_stride": 8,
                        "compute_dtype": "bfloat16"}}
    traffic = {"batch": 2, "crop": 65}
    assert splat.block_shapes(config, traffic) == [
        (2, 17, 17, 128), (2, 17, 17, 256), (2, 9, 9, 512), (2, 9, 9, 1024)]
    us = [2 * 17 * 17 * 128 * 2, 2 * 17 * 17 * 256 * 2, 2 * 9 * 9 * 512 * 2, 2 * 9 * 9 * 1024 * 2]
    assert splat.step_bytes(config, traffic) == sum(u + u // 2 + u // 2 + u + u for u in us)
    # Nothing in L2: 2|u| + |out|, then |dy| + |u| and |dy| + |du|, 5.5 |u|.
    assert splat.step_bytes(config, traffic, l2_bytes=0) == sum(11 * u // 2 for u in us)


def test_the_cell_s_split_attention_bytes():
    """33 blocks at batch 24, crop 512 (grid 128, then 64 from stage 2's
    first block on).  Only stage 2's last three u (24, 64, 64, 256), 48 MiB,
    fit in the 50 MiB L2: their combine writes out alone (2 |u| + |out|
    less |u|); every other block moves 5.5 |u|."""
    entry = BENCH.cell(CELL)
    config, traffic = BENCH.config(CONFIG), BENCH.traffic(entry["traffic"])
    shapes = splat.block_shapes(config, traffic)
    assert len(shapes) == 33
    assert shapes[:4] == [(24, 128, 128, 128)] * 3 + [(24, 128, 128, 256)]
    assert shapes[4:7] == [(24, 64, 64, 256)] * 3 and shapes[-1] == (24, 64, 64, 1024)
    us = [n * h * w * c * 2 for n, h, w, c in shapes]
    resident = sum(u for u in us if u <= splat.L2_BYTES)
    assert resident == 3 * 24 * 64 * 64 * 256 * 2
    assert splat.step_bytes(config, traffic) == sum(11 * u // 2 for u in us) - resident


def test_the_gated_loop_compares_the_head_apart():
    """train_gated's check holds train.py's numbers over every kept leaf
    and the median leaf's first-gradient gap over the head's kept leaves,
    which a trunk leaf does not move and a nought leaf
    (compare.kept_leaves) does not join."""
    ref_grad = {"backbone.layer1.0.conv2.fc1.weight": 1.0, "backbone.stem.0.weight": 2.0,
                "backbone.layer1.0.conv2.fc1.bias": 1e-12, "aspp1.conv.weight": 3.0,
                "fuse1.conv.weight": 3.5, "classifier.weight": 4.0, "classifier.bias": 1e-12}
    assert train_gated.head_leaves(ref_grad) == [
        "aspp1.conv.weight", "fuse1.conv.weight", "classifier.weight"]
    ref = {"loss": [1.0, 0.9, 0.8], "grad": ref_grad, "change": dict(ref_grad)}
    prog = {"loss": [1.0, 0.9, 0.8], "grad": dict(ref_grad), "change": dict(ref_grad)}
    prog["grad"].update({"classifier.weight": 4.4, "fuse1.conv.weight": 3.675})
    prog["grad"]["backbone.stem.0.weight"] = 6.0  # a trunk leaf 3x off
    numbers = train_gated.compare_readings(prog, ref)
    assert {k: numbers[k] for k in train.compare_readings(prog, ref)} == \
        train.compare_readings(prog, ref)
    # Over the head: gaps 0, 0.175 / 3.5 and 0.4 / 4 (the head's median
    # reference is 3.5); their median is fuse1's.
    assert numbers["head_grad_median_gap"] == pytest.approx(0.05)
    # Over every kept leaf (median reference 3.0): the stem's 4 / 3.
    assert numbers["grad_gap"] == pytest.approx(4.0 / 3.0)


def trace_with(ops, steps=2, config=None, traffic=None):
    return harness.Trace(profile={"device_ops": ops}, steps=steps, config=config,
                         traffic=traffic)


@pytest.mark.parametrize("name", ["splat_device_ms.train", "splat_roofline.train"])
def test_the_readers_leave_their_metric_out_without_splat_kernels(name):
    read = BENCH.metric_reader(name)
    ops = {"void (anonymous namespace)::bn_fwd_stats_kernel<__nv_bfloat16, 8>(...)": (0.01, 4),
           "sm90_xmma_fprop_implicit_gemm_bf16bf16": (0.5, 8)}
    assert read(trace_with(ops)) is None
    assert read(trace_with({})) is None


def test_the_readers_read_the_splat_kernels():
    entry = BENCH.cell(CELL)
    config, traffic = BENCH.config(CONFIG), BENCH.traffic(entry["traffic"])
    bound_s = splat.step_bytes(config, traffic) / splat.HBM_BYTES_PER_S
    ops = {"void (anonymous namespace)::splat_gap_kernel<__nv_bfloat16, 8>(...)": (bound_s, 66),
           "void (anonymous namespace)::splat_dx_kernel<__nv_bfloat16, 8>(...)": (bound_s, 66),
           "void (anonymous namespace)::bn_fwd_stats_kernel<__nv_bfloat16, 8>(...)": (1.0, 4)}
    trace = trace_with(ops, steps=2, config=config, traffic=traffic)
    assert BENCH.metric_reader("splat_device_ms.train")(trace) == pytest.approx(1e3 * bound_s)
    assert BENCH.metric_reader("splat_roofline.train")(trace) == pytest.approx(100.0)


# The tiny cell's limits: the first step's numbers as tiny.LIMITS holds
# them, the three steps' losses and the median leaf's change at 1e-2.  The
# gate's BN normalises the batch's few global means, which magnifies f32
# round-off: at batch 8 the first step reads 0 to 1e-6 and the median
# change 2.0e-4 to 2.9e-4 (three seeds); at batch 2 the first step read up
# to 0.021 and the worst leaf's change 0.39, so the batch is 8 and the
# worst leaf's change (0.004-0.015 at batch 8) is not compared.
TINY_LIMITS = {"loss1_gap": 1e-3, "grad_gap": 1e-3, "grad_median_gap": 1e-3, "loss_gap": 1e-2,
               "change_median_gap": 1e-2}


def test_a_tiny_resnest_cell_runs_and_is_correct(tmp_path):
    """The configuration cut to one block a stage, f32, batch 8 at 33x33,
    added as new files beside a copy of the benchmark's: the harness runs
    the port's ResNeSt and holds it against reference/resnest.py."""
    root = tiny.make_root(tmp_path)
    files = root / "benchmark"
    cfg = json.loads((spec.HERE / "configs" / f"{CONFIG}.json").read_text())
    cfg["name"] = "tiny-resnest"
    cfg["model"].update(compute_dtype="float32", layers=[1, 1, 1, 1])
    (files / "configs" / "tiny-resnest.json").write_text(json.dumps(cfg))
    traffic = json.loads((spec.HERE / "traffic" / "seen-train-b24-512.json").read_text())
    traffic.update(batch=8, crop=33, pool_batches=3, ignore_band=1, warmup_steps=1,
                   trace_steps=2, schedule_steps=100)
    (files / "traffic" / "tiny-seen-train-b24-512.json").write_text(json.dumps(traffic))
    (files / "limits" / "tiny-resnest-train.json").write_text(json.dumps({"limits": TINY_LIMITS}))
    data = json.loads((root / "BENCHMARK.json").read_text())
    data["configs"].append({"name": "tiny-resnest", "source": "arXiv:2004.08955",
                            "file": "benchmark/configs/tiny-resnest.json", "reduced": [],
                            "why": "tiny"})
    data["workloads"].append({"name": "tiny-resnest-train", "config": "tiny-resnest",
                              "traffic": "tiny-seen-train-b24-512", "chips": 1, "why": "tiny"})
    for metric in data["end_to_end"]:
        if metric["name"] == "train_images_per_s":  # as the cell: no p95
            metric["workloads"].append("tiny-resnest-train")
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    result = harness.run_cell(spec.Spec(root), "tiny-resnest-train", SEED, 0.5, False, "cpu",
                              time.perf_counter())
    assert result["correct"], result["checks"]
