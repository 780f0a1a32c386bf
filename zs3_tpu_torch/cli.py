"""Command line of the port (the ported subcommands of zs3_tpu.cli).

    python -m zs3_tpu_torch.cli evaluate --dataset synthetic --unseen-split 2
    python -m zs3_tpu_torch.cli train-gmmn --dataset synthetic --unseen-split 2

Flags override a JSON config (--config, zs3_tpu's format) which
overrides the defaults.  The command prints one JSON line.  It runs on
the GPU unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Any, Dict, Optional, Tuple

from zs3_tpu_torch.core.config import Config, context_unseen_split, voc_unseen_split


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--config", type=str, default=None, help="JSON config file")
    p.add_argument("--dataset", choices=["pascal", "context", "synthetic"])
    p.add_argument("--backbone", choices=["resnet101", "resnet50"])
    p.add_argument("--out-stride", type=int, choices=[8, 16])
    p.add_argument("--base-size", type=int)
    p.add_argument("--crop-size", type=int)
    p.add_argument("--batch-size", type=int)
    p.add_argument("--eval-batch-size", type=int)
    p.add_argument("--seed", type=int)
    p.add_argument("--resume", type=str,
                   help="state_dict .pt in the port's naming "
                        "(default: seeded random init)")
    p.add_argument("--unseen-split", type=int, choices=[0, 2, 4, 6, 8, 10],
                   help="number of unseen classes (paper protocol)")
    p.add_argument("--compute-dtype", choices=["bfloat16", "float32"])
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "PyTorch path)")


def _add_train_gmmn(p: argparse.ArgumentParser):
    p.add_argument("--epochs", type=int)
    p.add_argument("--steps-per-epoch", type=int)
    p.add_argument("--eval-interval", type=int)
    p.add_argument("--no-val", action="store_true", default=None,
                   help="never validate")
    p.add_argument("--pixels-per-class", type=int,
                   help="per-class pixel budget of the generator step")
    p.add_argument("--embedding-path", type=str,
                   help="class embeddings (.npy/.pkl/.npz); default: the "
                        "synthetic classes' own")


def build_config(args: argparse.Namespace) -> Config:
    cfg = Config()
    if args.config:
        with open(args.config) as f:
            cfg = Config.from_json(f.read())

    def upd(node, **kw):
        kw = {k: v for k, v in kw.items() if v is not None}
        return dataclasses.replace(node, **kw) if kw else node

    def flag(name):  # a flag that only some subcommands take
        return getattr(args, name, None)

    # --no-val: an effectively infinite eval interval, as in zs3_tpu.
    eval_interval = 10**9 if flag("no_val") else flag("eval_interval")

    unseen: Optional[tuple] = None
    if args.unseen_split is not None:
        if args.unseen_split == 0:
            unseen = ()
        else:
            dataset = args.dataset or cfg.data.dataset
            unseen = (
                context_unseen_split(args.unseen_split)
                if dataset == "context"
                else voc_unseen_split(args.unseen_split)
            )
    return dataclasses.replace(
        cfg,
        model=upd(
            cfg.model,
            backbone=args.backbone,
            output_stride=args.out_stride,
            compute_dtype=args.compute_dtype,
        ),
        gmmn=upd(cfg.gmmn, pixels_per_class=flag("pixels_per_class")),
        data=upd(
            cfg.data,
            dataset=args.dataset,
            base_size=args.base_size,
            crop_size=args.crop_size,
            batch_size=args.batch_size,
            eval_batch_size=args.eval_batch_size,
            unseen_classes=unseen,
            embedding_path=flag("embedding_path"),
        ),
        train=upd(
            cfg.train,
            seed=args.seed,
            resume=args.resume,
            epochs=flag("epochs"),
            steps_per_epoch=flag("steps_per_epoch"),
            eval_interval=eval_interval,
        ),
    )


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="zs3_tpu_torch",
        description="zero-shot semantic segmentation, PyTorch/CUDA port",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    _add_common(sub.add_parser("evaluate"))
    gmmn = sub.add_parser("train-gmmn")
    _add_common(gmmn)
    _add_train_gmmn(gmmn)
    return parser


def run(argv=None) -> Tuple[Dict[str, float], Optional[Any]]:
    """Run one command without printing: (its result, the GMMNTrainer that
    `train-gmmn` ran, or None for `evaluate`)."""
    args = make_parser().parse_args(argv)
    cfg = build_config(args)

    if args.command == "evaluate":
        from zs3_tpu_torch.train.seen import evaluate

        return evaluate(cfg, device=args.device), None
    if args.command == "train-gmmn":
        from zs3_tpu_torch.train.gmmn import GMMNTrainer

        trainer = GMMNTrainer(cfg, device=args.device)
        return trainer.fit(), trainer
    raise AssertionError(args.command)  # pragma: no cover


def main(argv=None) -> int:
    result, _ = run(argv)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
