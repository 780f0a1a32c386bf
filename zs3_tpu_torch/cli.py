"""Command line of the port (the ported subcommands of zs3_tpu.cli).

    python -m zs3_tpu_torch.cli evaluate --dataset synthetic --unseen-split 2

Flags override a JSON config (--config, zs3_tpu's format) which
overrides the defaults.  The command prints one JSON line.  It runs on
the GPU unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Optional

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


def build_config(args: argparse.Namespace) -> Config:
    cfg = Config()
    if args.config:
        with open(args.config) as f:
            cfg = Config.from_json(f.read())

    def upd(node, **kw):
        kw = {k: v for k, v in kw.items() if v is not None}
        return dataclasses.replace(node, **kw) if kw else node

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
        data=upd(
            cfg.data,
            dataset=args.dataset,
            base_size=args.base_size,
            crop_size=args.crop_size,
            batch_size=args.batch_size,
            eval_batch_size=args.eval_batch_size,
            unseen_classes=unseen,
        ),
        train=upd(cfg.train, seed=args.seed, resume=args.resume),
    )


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="zs3_tpu_torch",
        description="zero-shot semantic segmentation, PyTorch/CUDA port",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    _add_common(sub.add_parser("evaluate"))
    return parser


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    cfg = build_config(args)

    if args.command == "evaluate":
        from zs3_tpu_torch.train.seen import evaluate

        result = evaluate(cfg, device=args.device)
    else:  # pragma: no cover
        raise AssertionError(args.command)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
