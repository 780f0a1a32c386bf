"""zs3_tpu's synthetic zero-shot chain on the CPU, its states carried into
the port's formats: the reference side of the release rehearsal's
transfer comparison.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python -m tests.torch_port_reference_run OUT [--epochs 20,45,30]
    python -m tests.torch_port_reference_run OUT --port [--device cpu]

Runs tests/test_zero_shot_acceptance.py's configuration (ResNet-50 at
49², 10 classes, unseen (3, 5), f32; the port's
release_rehearsal.synthetic_config) through zs3_tpu: seen training, the
ZS3 leg, its int8 validation, ZS5 warm-started from the ZS3 states.  On 8
virtual CPU devices, as zs3_tpu's tests run it (tests/conftest.py), each
device's train-mode BN takes the statistics of its own image
(bn_axis_name None); on one device, of the whole batch.
Writes OUT/trunk.pt (the seen trunk as a port checkpoint, {"model":
state_dict}), OUT/zs3.pt (the ZS3 generator's state_dict and its
classifier, {"gen", "cls"}), and OUT/reports.json (zs3_tpu's validation
reports: seen, zs3, zs3_int8, zs5).  With --port, the port side (no JAX:
it runs on the card by default) reads OUT: it validates the carried
states and compares them with zs3_tpu's reports, then trains the port's
generator and ZS5 from zs3_tpu's trunk, each with cuDNN's TF32 on and
off; one JSON line each.
The slow test_zs3_tpu_states_carry_into_the_port
(tests/test_torch_port_rehearsal.py) is the standing check of the first
part, on the CPU.
"""

import argparse
import dataclasses
import json
import os
import sys
import tempfile

import numpy as np
import torch


def reference_run(out_dir: str, scratch: str, epochs=(20, 45, 30)) -> dict:
    """zs3_tpu's chain with its checkpoints and logs under `scratch`; the
    carried states and the reports into `out_dir`."""
    import jax

    from zs3_tpu.core.config import (
        Config, DataConfig, GMMNConfig, ModelConfig, OptimConfig, TrainConfig)
    from zs3_tpu.train.gmmn import GMMNTrainer
    from zs3_tpu.train.seen import SeenTrainer
    from zs3_tpu.train.self_training import ZS5Trainer
    from zs3_tpu_torch.utils.convert import gmmn_state_dict_from_flax, state_dict_from_flax

    e_seen, e_gmmn, e_zs5 = epochs
    scratch = os.path.abspath(scratch)  # orbax takes absolute paths only
    os.makedirs(out_dir, exist_ok=True)
    cfg = Config(
        model=ModelConfig(backbone="resnet50", num_classes=10, compute_dtype="float32",
                          dropout=False),
        gmmn=GMMNConfig(embed_dim=8, noise_dim=8, hidden_dim=128, pixels_per_class=64),
        data=DataConfig(dataset="synthetic", crop_size=49, base_size=49, batch_size=8,
                        eval_batch_size=8, unseen_classes=(3, 5), synthetic_classes=10,
                        synthetic_items=32, synthetic_embed_dim=8, synthetic_tint_weight=1.0),
        optim=OptimConfig(lr=0.02, gmmn_lr=1e-3, classifier_lr=1e-2),
        train=TrainConfig(epochs=e_seen, eval_interval=10**9,
                          checkpoint_dir=os.path.join(scratch, "seen"), keep_checkpoints=1),
    )
    seen = SeenTrainer(cfg)
    for e in range(e_seen):
        seen.train_epoch(e)
    reports = {"seen": seen.validate(e_seen - 1)}
    variables = jax.device_get({"params": seen.state.params,
                                "batch_stats": seen.state.batch_stats})
    torch.save({"model": state_dict_from_flax(variables)}, os.path.join(out_dir, "trunk.pt"))

    gcfg = cfg.replace(train=dataclasses.replace(cfg.train, epochs=e_gmmn))
    t = GMMNTrainer(gcfg, seg_variables=variables)
    for e in range(e_gmmn):
        t.train_epoch(e)
    reports["zs3"] = t.validate(e_gmmn - 1)
    cls = jax.device_get(t.cls_state.params)
    torch.save({"gen": gmmn_state_dict_from_flax(jax.device_get(t.gen_state.params)),
                "cls": {k: torch.from_numpy(np.asarray(v, np.float32).copy())
                        for k, v in cls.items()}},
               os.path.join(out_dir, "zs3.pt"))

    qcfg = gcfg.replace(train=dataclasses.replace(gcfg.train, int8_eval=True))
    tq = GMMNTrainer(qcfg, seg_variables=variables)
    tq.gen_state, tq.cls_state = t.gen_state, t.cls_state
    reports["zs3_int8"] = tq.validate(e_gmmn - 1)

    z5cfg = gcfg.replace(train=dataclasses.replace(
        gcfg.train, epochs=e_zs5, checkpoint_dir=os.path.join(scratch, "zs5")))
    t5 = ZS5Trainer(z5cfg, seg_variables=variables)
    t5.gen_state, t5.cls_state = t.gen_state, t.cls_state
    t5.pseudo_label()
    for e in range(e_zs5):
        t5.train_epoch(e)
    reports["zs5"] = t5.validate(e_zs5 - 1)
    reports = {k: {m: float(v) for m, v in r.items() if v is not None}
               for k, r in reports.items()}
    with open(os.path.join(out_dir, "reports.json"), "w") as f:
        json.dump({"epochs": list(epochs), "reports": reports}, f, indent=1)
    return reports


def port_transfer(ref_dir: str, scratch: str, device: str = "cuda") -> None:
    """The port's side: zs3_tpu's seen trunk and ZS3 generator and
    classifier (reference_run's `ref_dir`) validated by the port beside
    zs3_tpu's own validation, then the port's ZS3 leg and ZS5 trained from
    zs3_tpu's trunk; each with cuDNN's TF32 on (torch's default) and off.
    Prints one JSON line a comparison."""
    from zs3_tpu_torch import release_rehearsal as rr
    from zs3_tpu_torch.train.seen import SeenTrainer
    from zs3_tpu_torch.train.self_training import ZS5Trainer

    with open(os.path.join(ref_dir, "reports.json")) as f:
        reference = json.load(f)
    e_seen, e_gmmn, e_zs5 = reference["epochs"]
    want = reference["reports"]
    trunk = os.path.join(ref_dir, "trunk.pt")
    carried = torch.load(os.path.join(ref_dir, "zs3.pt"), weights_only=True)
    keys = ("miou", "seen_miou", "unseen_miou", "harmonic_miou")

    def emit(**fields):
        print(json.dumps(fields), flush=True)

    for tf32 in (True, False):
        work = os.path.join(scratch, f"tf32_{tf32}")
        saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            cfg = rr.synthetic_config(work, e_seen)
            cfg = cfg.replace(train=dataclasses.replace(cfg.train, resume=trunk))
            seen = SeenTrainer(cfg.replace(train=dataclasses.replace(cfg.train, finetune=True)),
                               device=device).validate(0)
            t, _ = rr.synthetic_zs3(cfg, trunk, 0, device)
            t.generator.load_state_dict(carried["gen"])
            with torch.no_grad():
                for key, value in carried["cls"].items():
                    t.step.cls[key].copy_(value.to(device))
            zs3_carried = t.validate(0)
            emit(tf32=tf32, check="zs3_tpu's states validated by the port",
                 seen={k: seen[k] for k in keys}, zs3_tpu_seen={k: want["seen"][k] for k in keys},
                 zs3={k: zs3_carried[k] for k in keys},
                 zs3_tpu_zs3={k: want["zs3"][k] for k in keys})
            t, zs3 = rr.synthetic_zs3(cfg, trunk, e_gmmn, device)
            z5cfg = t.cfg.replace(train=dataclasses.replace(
                t.cfg.train, epochs=e_zs5, checkpoint_dir=os.path.join(work, "zs5")))
            t5 = ZS5Trainer(z5cfg, device=device)
            t5.load_checkpoint(t.checkpoint_payload())
            t5.pseudo_label()
            for e in range(e_zs5):
                t5.train_epoch(e)
            zs5 = t5.validate(e_zs5 - 1)
            emit(tf32=tf32, check="the port's ZS3 and ZS5 from zs3_tpu's trunk",
                 zs3={k: zs3[k] for k in keys}, zs5={k: zs5[k] for k in keys},
                 zs3_tpu_zs3={k: want["zs3"][k] for k in keys},
                 zs3_tpu_zs5={k: want["zs5"][k] for k in keys})
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("out")
    p.add_argument("--epochs", default="20,45,30")
    p.add_argument("--port", action="store_true",
                   help="run the port's side on OUT (no JAX) instead of zs3_tpu's")
    p.add_argument("--device", default="cuda", help="the port's device (with --port)")
    args = p.parse_args(argv)
    if args.port:
        with tempfile.TemporaryDirectory() as scratch:
            port_transfer(args.out, scratch, args.device)
        return 0
    import jax

    jax.config.update("jax_platforms", "cpu")
    with tempfile.TemporaryDirectory() as scratch:
        reports = reference_run(args.out, scratch,
                                tuple(int(e) for e in args.epochs.split(",")))
    print(json.dumps(reports))
    return 0


if __name__ == "__main__":
    sys.exit(main())
