"""Command line of the port (the ported subcommands of zs3_tpu.cli).

    python -m zs3_tpu_torch.cli train-seen --dataset synthetic --unseen-split 2
    python -m zs3_tpu_torch.cli evaluate --dataset synthetic --unseen-split 2 --resume CKPT
    python -m zs3_tpu_torch.cli train-gmmn --dataset synthetic --unseen-split 2 --resume CKPT
    python -m zs3_tpu_torch.cli evaluate-gmmn --unseen-split 2 --resume CKPT --gmmn-resume CKPT
    python -m zs3_tpu_torch.cli train-zs5 --dataset synthetic --unseen-split 2 --resume CKPT
    python -m zs3_tpu_torch.cli train-gmmn --graph-context --unseen-split 2 --resume CKPT
    python -m zs3_tpu_torch.cli train-seen --dataset pascal --use-sbd --data-root /data
    python -m zs3_tpu_torch.cli infer img1.png img2.jpg --output preds --fused-tail
    python -m zs3_tpu_torch.cli serve --port 8500 --serve-batch 8 --fused-tail
    python -m zs3_tpu_torch.cli prepare-context trainval_merged.json --data-root /data
    python -m zs3_tpu_torch.cli build-embeddings GoogleNews.bin --dataset context --output e.npy

Flags override a JSON config (--config, zs3_tpu's format) which
overrides the defaults.  The command prints one JSON line.  It runs on
the GPU unless --device cpu is given.  Checkpoints go to
<checkpoint-dir>/<dataset>/<checkname>[-gmmn|-zs5]/experiment_N/.
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
    p.add_argument("--data-root", type=str,
                   help="directory holding VOC2012/ (and benchmark_RELEASE/ for SBD) "
                        "or VOC2010/ for Pascal-Context")
    p.add_argument("--use-sbd", action="store_true", default=None,
                   help="train on VOC2012 + SBD (pascal)")
    p.add_argument("--backbone", choices=["resnet101", "resnet50"])
    p.add_argument("--out-stride", type=int, choices=[8, 16])
    p.add_argument("--base-size", type=int)
    p.add_argument("--crop-size", type=int)
    p.add_argument("--batch-size", type=int)
    p.add_argument("--eval-batch-size", type=int)
    p.add_argument("--seed", type=int)
    p.add_argument("--resume", type=str,
                   help="train-seen checkpoint, or a state_dict .pt in the port's "
                        "naming (default: seeded random init)")
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


def _add_checkpoints(p: argparse.ArgumentParser):
    p.add_argument("--checkname", type=str)
    p.add_argument("--checkpoint-dir", type=str)
    p.add_argument("--ft", action="store_true", default=None,
                   help="fine-tune: load weights only, fresh optimizer and step")
    p.add_argument("--gmmn-resume", type=str,
                   help="GMMN-stage checkpoint to resume or evaluate")
    p.add_argument("--auto-resume", action="store_true", default=None,
                   help="resume from the newest checkpoint of the newest experiment "
                        "of this (dataset, checkname), if any")


def _add_schedule(p: argparse.ArgumentParser):
    p.add_argument("--epochs", type=int)
    p.add_argument("--steps-per-epoch", type=int)
    p.add_argument("--eval-interval", type=int)
    p.add_argument("--no-val", action="store_true", default=None,
                   help="never validate (the final state is still saved)")


def _add_train_seen(p: argparse.ArgumentParser):
    p.add_argument("--lr", type=float)
    p.add_argument("--lr-scheduler", choices=["poly", "step", "cos", "const"])
    p.add_argument("--nesterov", action="store_true", default=None)
    p.add_argument("--loss-type", choices=["ce", "focal"])
    p.add_argument("--use-balanced-weights", action="store_true", default=None)
    p.add_argument("--grad-accum", type=int,
                   help="microbatches per optimizer step: batch-size stays the "
                        "effective batch")
    p.add_argument("--qat", action="store_true", default=None,
                   help="quantization-aware training (not ported yet; refused)")


def _add_gmmn(p: argparse.ArgumentParser):
    p.add_argument("--pixels-per-class", type=int,
                   help="per-class pixel budget of the generator step")
    p.add_argument("--embedding-path", type=str,
                   help="class embeddings (.npy/.pkl/.npz, e.g. from build-embeddings); "
                        "default: seeded per-name vectors (synthetic data: its "
                        "classes' own)")
    p.add_argument("--graph-context", action="store_true", default=None,
                   help="graph-context generator: condition on the classes of "
                        "neighbouring regions (GraphContextGMMN)")


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


def _add_prepare_context(p: argparse.ArgumentParser):
    p.add_argument("json", help="detail-API trainval_merged.json")
    p.add_argument("--overwrite", action="store_true",
                   help="regenerate label PNGs that already exist")


def _add_build_embeddings(p: argparse.ArgumentParser):
    p.add_argument("vectors", nargs="+",
                   help="word-vector file(s): word2vec .bin, word2vec/fasttext/GloVe "
                        "text, or existing .npy/.npz/.pkl registries; several files "
                        "concatenate feature-wise (fastnvec)")
    p.add_argument("--output", type=str, required=True,
                   help="registry .npy to write (rows ordered by the dataset's class "
                        "list; pass it to the trainers with --embedding-path)")
    p.add_argument("--no-normalize", action="store_true",
                   help="keep raw vector norms (default: unit rows)")
    p.add_argument("--alias", action="append", default=[], metavar="NAME=TOKENS",
                   help="extra class-name alias, e.g. 'tvmonitor=television'; repeatable")


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
        gmmn=upd(cfg.gmmn, pixels_per_class=flag("pixels_per_class"),
                 graph_context=flag("graph_context")),
        data=upd(
            cfg.data,
            dataset=args.dataset,
            root=args.data_root,
            use_sbd=args.use_sbd,
            base_size=args.base_size,
            crop_size=args.crop_size,
            batch_size=args.batch_size,
            eval_batch_size=args.eval_batch_size,
            unseen_classes=unseen,
            embedding_path=flag("embedding_path"),
        ),
        optim=upd(
            cfg.optim,
            lr=flag("lr"),
            loss_type=flag("loss_type"),
            use_balanced_weights=flag("use_balanced_weights"),
            schedule=flag("lr_scheduler"),
            nesterov=flag("nesterov"),
        ),
        train=upd(
            cfg.train,
            seed=args.seed,
            resume=args.resume,
            gmmn_resume=flag("gmmn_resume"),
            finetune=flag("ft"),
            checkname=flag("checkname"),
            checkpoint_dir=flag("checkpoint_dir"),
            grad_accum=flag("grad_accum"),
            qat=flag("qat"),
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
    seen = sub.add_parser("train-seen")
    _add_common(seen)
    _add_checkpoints(seen)
    _add_schedule(seen)
    _add_train_seen(seen)
    evaluate = sub.add_parser("evaluate")
    _add_common(evaluate)
    _add_checkpoints(evaluate)
    _add_int8(evaluate)
    for name in ("train-gmmn", "train-zs5"):
        train = sub.add_parser(name)
        _add_common(train)
        _add_checkpoints(train)
        _add_schedule(train)
        _add_gmmn(train)
    evaluate_gmmn = sub.add_parser("evaluate-gmmn")
    _add_common(evaluate_gmmn)
    _add_checkpoints(evaluate_gmmn)
    _add_gmmn(evaluate_gmmn)
    _add_int8(evaluate_gmmn)
    infer = sub.add_parser("infer")
    _add_common(infer)
    _add_int8(infer)
    _add_infer(infer)
    serve = sub.add_parser("serve")
    _add_common(serve)
    _add_int8(serve)
    _add_serve(serve)
    prepare = sub.add_parser("prepare-context")
    _add_common(prepare)
    _add_prepare_context(prepare)
    build = sub.add_parser("build-embeddings")
    _add_common(build)
    _add_build_embeddings(build)
    return parser


def auto_resume(cfg: Config, command: str) -> Config:
    """cfg resuming from the newest checkpoint of the newest experiment of
    this stage, when there is one and no checkpoint is named.  Each stage
    saves under its own checkname (<checkname> for seen training and
    evaluation, <checkname>-gmmn for the GMMN stage, <checkname>-zs5 for
    ZS5), so a stage never restores another's state; the GMMN and ZS5
    stages resume through gmmn_resume."""
    from zs3_tpu_torch.utils.saver import Saver

    suffix = {"train-gmmn": "-gmmn", "evaluate-gmmn": "-gmmn", "train-zs5": "-zs5"}.get(
        command, "")
    field = "gmmn_resume" if suffix else "resume"
    exp = Saver.latest_experiment(cfg.train.checkpoint_dir, cfg.data.dataset,
                                  cfg.train.checkname + suffix)
    if exp and not getattr(cfg.train, field):
        ckpt = Saver.latest_checkpoint(exp)
        print(f"auto-resume: {ckpt}", file=sys.stderr)
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, **{field: ckpt}))
    return cfg


def run(argv=None) -> Tuple[Dict[str, Any], Optional[Any]]:
    """Run one command without printing: (its result, the object it ran:
    the SeenTrainer of `train-seen` and `evaluate`, the GMMNTrainer of
    `train-gmmn` and `evaluate-gmmn`, the ZS5Trainer of `train-zs5`, the
    Predictor of `infer`, the InferenceServer of `serve` once it stops;
    None for `prepare-context` and `build-embeddings`, which run on the
    host alone).
    `train-zs5` pseudo-labels the train set (the count goes to stderr),
    then trains."""
    args = make_parser().parse_args(argv)
    cfg = build_config(args)
    if getattr(args, "auto_resume", None):
        cfg = auto_resume(cfg, args.command)
    if getattr(args, "int8", False):
        raise SystemExit(f"{args.command} --int8: int8 inference is not ported yet "
                         "(see ROADMAP Queue 1, Quantization)")
    if getattr(args, "artifact", None):
        raise SystemExit("serve --artifact: exported artifacts are not ported yet "
                         "(see ROADMAP Queue 1, Export)")

    if args.command in ("train-seen", "evaluate"):
        from zs3_tpu_torch.train.seen import SeenTrainer

        trainer = SeenTrainer(cfg, device=args.device)
        if args.command == "evaluate":
            return trainer.validate(epoch=0), trainer
        return trainer.fit(), trainer
    if args.command in ("train-gmmn", "evaluate-gmmn"):
        from zs3_tpu_torch.train.gmmn import GMMNTrainer

        trainer = GMMNTrainer(cfg, device=args.device)
        if args.command == "evaluate-gmmn":
            return trainer.validate(epoch=0), trainer
        return trainer.fit(), trainer
    if args.command == "train-zs5":
        from zs3_tpu_torch.train.self_training import ZS5Trainer

        trainer = ZS5Trainer(cfg, device=args.device)
        print(f"pseudo-labeled {trainer.pseudo_label()} images", file=sys.stderr)
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
    if args.command == "prepare-context":
        from zs3_tpu_torch.data.context_prepare import prepare_context

        return prepare_context(args.json, cfg.data.root, overwrite=args.overwrite), None
    if args.command == "build-embeddings":
        from zs3_tpu_torch.data.classes import CONTEXT_CLASSES, VOC_CLASSES
        from zs3_tpu_torch.data.embedding_build import build_embedding_registry

        names = CONTEXT_CLASSES if cfg.data.dataset == "context" else VOC_CLASSES
        aliases = {}
        for spec in args.alias:
            key, _, val = spec.partition("=")
            if not val:
                raise SystemExit(f"--alias expects NAME=TOKENS, got {spec!r}")
            aliases[key.lower()] = val
        return build_embedding_registry(names, args.vectors, args.output,
                                        normalize=not args.no_normalize,
                                        aliases=aliases), None
    raise AssertionError(args.command)  # pragma: no cover


def main(argv=None) -> int:
    result, _ = run(argv)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
