"""Command line of the port (the ported subcommands of zs3_tpu.cli).

    python -m zs3_tpu_torch.cli evaluate --dataset synthetic --unseen-split 2
    python -m zs3_tpu_torch.cli train-gmmn --dataset synthetic --unseen-split 2
    python -m zs3_tpu_torch.cli infer img1.png img2.jpg --output preds --fused-tail
    python -m zs3_tpu_torch.cli serve --port 8500 --serve-batch 8 --fused-tail

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
    p.add_argument("--fused-tail", action="store_true", default=None,
                   help="fused classify+upsample inference tail (kernel K4 on the "
                        "GPU; exact-4x geometry, eval only)")
    p.add_argument("--eval-scales", type=str,
                   help="comma-separated TTA scales, e.g. 0.5,0.75,1.0,1.25"
                        " (default: 1.0 = reference single-scale)")
    p.add_argument("--eval-flip", action="store_true", default=None,
                   help="add horizontal-mirror TTA at evaluation")
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


def _add_int8(p: argparse.ArgumentParser):
    p.add_argument("--int8", action="store_true",
                   help="int8 PTQ inference (not ported yet; refused)")


def _add_infer(p: argparse.ArgumentParser):
    p.add_argument("images", nargs="+", help="image files to segment")
    p.add_argument("--output", type=str, default="predictions")
    p.add_argument("--no-color", action="store_true")
    p.add_argument("--sliding", action="store_true",
                   help="native-resolution sliding-window inference "
                        "(overlapping crops, averaged probabilities) "
                        "instead of a global resize")


def _add_serve(p: argparse.ArgumentParser):
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8500)
    p.add_argument("--serve-batch", type=int, default=1,
                   help="micro-batch up to N concurrent requests onto one forward")
    p.add_argument("--artifact", type=str, default=None,
                   help="serve an exported artifact (not ported yet; refused)")


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
            fused_tail=args.fused_tail,
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
            eval_scales=(
                tuple(float(v) for v in args.eval_scales.split(","))
                if args.eval_scales
                else None
            ),
            eval_flip=args.eval_flip,
        ),
    )


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="zs3_tpu_torch",
        description="zero-shot semantic segmentation, PyTorch/CUDA port",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    evaluate = sub.add_parser("evaluate")
    _add_common(evaluate)
    _add_int8(evaluate)
    gmmn = sub.add_parser("train-gmmn")
    _add_common(gmmn)
    _add_train_gmmn(gmmn)
    infer = sub.add_parser("infer")
    _add_common(infer)
    _add_int8(infer)
    _add_infer(infer)
    serve = sub.add_parser("serve")
    _add_common(serve)
    _add_int8(serve)
    _add_serve(serve)
    return parser


def run(argv=None) -> Tuple[Dict[str, Any], Optional[Any]]:
    """Run one command without printing: (its result, the object it ran:
    the GMMNTrainer of `train-gmmn`, the Predictor of `infer`, the
    InferenceServer of `serve` once it stops, None for `evaluate`)."""
    args = make_parser().parse_args(argv)
    cfg = build_config(args)
    if getattr(args, "int8", False):
        raise SystemExit(f"{args.command} --int8: int8 inference is not ported yet "
                         "(ROADMAP Queue 1 item 10)")
    if getattr(args, "artifact", None):
        raise SystemExit("serve --artifact: exported artifacts are not ported yet "
                         "(ROADMAP Queue 1 item 11)")

    if args.command == "evaluate":
        from zs3_tpu_torch.train.seen import evaluate

        return evaluate(cfg, device=args.device), None
    if args.command == "train-gmmn":
        from zs3_tpu_torch.train.gmmn import GMMNTrainer

        trainer = GMMNTrainer(cfg, device=args.device)
        return trainer.fit(), trainer
    if args.command == "infer":
        from zs3_tpu_torch.train.predict import Predictor

        predictor = Predictor(cfg, device=args.device)
        written = predictor.predict_files(
            args.images, args.output, colorize=not args.no_color, sliding=args.sliding,
        )
        return {"written": len(written), "output": args.output}, predictor
    if args.command == "serve":
        from zs3_tpu_torch.serve import InferenceServer

        server = InferenceServer(cfg, host=args.host, port=args.port,
                                 serve_batch=args.serve_batch, device=args.device)
        print(json.dumps({"serving": f"http://{args.host}:{server.port}"}),
              file=sys.stderr, flush=True)
        try:
            server.serve_forever()
        finally:
            server.httpd.server_close()
        return {"served": f"http://{args.host}:{server.port}"}, server
    raise AssertionError(args.command)  # pragma: no cover


def main(argv=None) -> int:
    result, _ = run(argv)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
