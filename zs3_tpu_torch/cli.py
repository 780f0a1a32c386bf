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
    python -m zs3_tpu_torch.cli evaluate --int8 --int8-percentile 99.99 --resume CKPT
    python -m zs3_tpu_torch.cli serve --int8 --calib-images a.jpg b.jpg --serve-batch 8
    python -m zs3_tpu_torch.cli train-seen --qat --dataset synthetic --unseen-split 2
    python -m zs3_tpu_torch.cli train-gmmn --int8-features --unseen-split 2 --resume CKPT
    python -m zs3_tpu_torch.cli prepare-context trainval_merged.json --data-root /data
    python -m zs3_tpu_torch.cli build-embeddings GoogleNews.bin --dataset context --output e.npy
    python -m zs3_tpu_torch.cli convert-weights xception.pth --backbone xception --output init.pt
    python -m zs3_tpu_torch.cli train-seen --backbone xception --resume init.pt --ft
    python -m zs3_tpu_torch.cli show-config --backbone drn --crop-size 321
    python -m zs3_tpu_torch.cli profile --mode fwd --steps 10 --trace-dir trace
    python -m zs3_tpu_torch.cli export --output model.pt2 --resume CKPT --gmmn-resume CKPT
    python -m zs3_tpu_torch.cli serve --artifact model.pt2
    python -m zs3_tpu_torch.cli train-seen --dataset pascal --config tfdata.json \
        --compilation-cache /cache/kernels   # tfdata.json: {"data": {"input_pipeline": "tfdata"}}

Flags override a JSON config (--config, zs3_tpu's format) which
overrides the defaults.  The command prints one JSON line.  It runs on
the GPU unless --device cpu is given.  Every subcommand builds and loads
the CUDA kernels in --compilation-cache DIR (default
$ZS3_COMPILATION_CACHE, else build/kernels).  Checkpoints go to
<checkpoint-dir>/<dataset>/<checkname>[-gmmn|-zs5]/experiment_N/.
train-seen, evaluate, train-gmmn, evaluate-gmmn and train-zs5 run
data-parallel under torchrun (one rank a card; gloo ranks with --device
cpu), and rank 0 alone prints and writes:

    torchrun --standalone --nproc_per_node 8 -m zs3_tpu_torch.cli train-seen ...
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Any, Dict, Optional, Tuple

from zs3_tpu_torch.core.config import Config, context_unseen_split, voc_unseen_split
from zs3_tpu_torch.ops import cuda_build


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--config", type=str, default=None, help="JSON config file")
    p.add_argument("--compilation-cache", type=str, metavar="DIR",
                   default=os.environ.get("ZS3_COMPILATION_CACHE"),
                   help="directory the CUDA kernels are built into and loaded from "
                        "(default: $ZS3_COMPILATION_CACHE, else build/kernels); a restarted "
                        "job with the same DIR runs no nvcc")
    p.add_argument("--dataset", choices=["pascal", "context", "synthetic"])
    p.add_argument("--data-root", type=str,
                   help="directory holding VOC2012/ (and benchmark_RELEASE/ for SBD) "
                        "or VOC2010/ for Pascal-Context")
    p.add_argument("--use-sbd", action="store_true", default=None,
                   help="train on VOC2012 + SBD (pascal)")
    p.add_argument("--backbone", choices=["resnet101", "resnet50", "xception", "mobilenet",
                                          "drn"])
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
                   help="quantization-aware training: convs train on fake-quantized "
                        "int8-grid operands (straight-through gradients), so the trunk "
                        "loses less accuracy under evaluate/infer/serve --int8")


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


def _add_int8_percentile(p: argparse.ArgumentParser):
    p.add_argument("--int8-percentile", type=float, default=None, metavar="P",
                   help="calibrate int8 activation scales to this percentile of "
                        "|conv input| (e.g. 99.99) instead of its max (default: absmax)")


def _add_int8(p: argparse.ArgumentParser, help: str):
    p.add_argument("--int8", action="store_true", help=help)
    _add_int8_percentile(p)


_EVAL_INT8 = ("validate with int8 PTQ convs, calibrated on the first 2 val batches "
              "(s8 x s8 -> s32 on the GPU)")
_INFER_INT8 = "int8 PTQ inference, calibrated on the first 8 input images"
_SERVE_INT8 = "int8 PTQ inference; requires --calib-images"


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
                   help="serve an exported labels artifact (cli export) instead of a "
                        "checkpoint; its batch and size come from its manifest")
    p.add_argument("--calib-images", nargs="+", default=None,
                   help="representative images for int8 activation calibration")


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


def _add_profile(p: argparse.ArgumentParser):
    p.add_argument("--steps", type=int, default=10,
                   help="steps to time (the first is a warm-up)")
    p.add_argument("--trace-dir", type=str, default=None,
                   help="write a torch.profiler trace here (chrome://tracing, Perfetto)")
    p.add_argument("--mode", default="train", choices=["train", "fwd", "int8-fwd"],
                   help="what to profile: the seen train step, the eval forward, or the "
                        "int8 PTQ forward (constant stand-in scales: the throughput is "
                        "faithful, the accuracy is not)")


def _add_export(p: argparse.ArgumentParser):
    p.add_argument("--output", type=str, required=True,
                   help="torch.export artifact path (.pt2; the manifest goes to <output>.json)")
    p.add_argument("--export-batch", type=int, default=1)
    p.add_argument("--emit", choices=["labels", "logits"], default="labels")
    p.add_argument("--platforms", type=str, default=None,
                   help="the one device type to export for, cuda or cpu (default: --device); "
                        "an artifact holds one device's weights")
    p.add_argument("--allow-random", action="store_true",
                   help="permit exporting without a checkpoint (randomly initialized "
                        "weights; smoke artifacts only)")
    p.add_argument("--calib-images", nargs="+", default=None,
                   help="representative images for int8 activation calibration")


def _add_convert_weights(p: argparse.ArgumentParser):
    p.add_argument("pth", help="upstream-named backbone state_dict .pth (torchvision "
                               "ResNet, or the Xception, MobileNetV2 and DRN namings)")
    p.add_argument("--output", type=str, required=True,
                   help="checkpoint file to write (use with --resume --ft)")
    p.add_argument("--force", action="store_true",
                   help="replace an existing --output checkpoint")


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
    # --int8 of evaluate[-gmmn] is int8 validation; infer and serve calibrate
    # on their images instead.
    int8_eval = True if flag("int8") and args.command in ("evaluate", "evaluate-gmmn") else None

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
            int8_eval=int8_eval,
            int8_features=flag("int8_features"),
            int8_percentile=flag("int8_percentile"),
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
    _add_int8(evaluate, _EVAL_INT8)
    for name in ("train-gmmn", "train-zs5"):
        train = sub.add_parser(name)
        _add_common(train)
        _add_checkpoints(train)
        _add_schedule(train)
        _add_gmmn(train)
        train.add_argument("--int8-features", action="store_true", default=None,
                           help="extract the frozen trunk's features with int8 convs "
                                "(calibrated on the first 2 val batches); validation "
                                "and ZS5's pseudo-labels run int8 too")
        _add_int8_percentile(train)
    evaluate_gmmn = sub.add_parser("evaluate-gmmn")
    _add_common(evaluate_gmmn)
    _add_checkpoints(evaluate_gmmn)
    _add_gmmn(evaluate_gmmn)
    _add_int8(evaluate_gmmn, _EVAL_INT8)
    infer = sub.add_parser("infer")
    _add_common(infer)
    _add_int8(infer, _INFER_INT8)
    _add_infer(infer)
    serve = sub.add_parser("serve")
    _add_common(serve)
    _add_int8(serve, _SERVE_INT8)
    _add_serve(serve)
    prepare = sub.add_parser("prepare-context")
    _add_common(prepare)
    _add_prepare_context(prepare)
    build = sub.add_parser("build-embeddings")
    _add_common(build)
    _add_build_embeddings(build)
    show = sub.add_parser("show-config")  # every flag that sets a config field
    _add_common(show)
    _add_checkpoints(show)
    _add_schedule(show)
    _add_train_seen(show)
    _add_gmmn(show)
    show.add_argument("--int8-features", action="store_true", default=None)
    _add_int8_percentile(show)
    profile = sub.add_parser("profile")
    _add_common(profile)
    _add_checkpoints(profile)
    _add_train_seen(profile)
    _add_profile(profile)
    export = sub.add_parser("export")
    _add_common(export)
    _add_checkpoints(export)
    _add_int8(export, "bake int8 convs into the artifact; requires --calib-images")
    _add_export(export)
    convert = sub.add_parser("convert-weights")
    _add_common(convert)
    _add_checkpoints(convert)
    _add_convert_weights(convert)
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


DATA_PARALLEL = ("train-seen", "evaluate", "train-gmmn", "evaluate-gmmn", "train-zs5")


def run(argv=None) -> Tuple[Dict[str, Any], Optional[Any]]:
    """Run one command without printing: (its result, the object it ran:
    the SeenTrainer of `train-seen`, `evaluate` and `profile`, the
    GMMNTrainer of `train-gmmn` and `evaluate-gmmn`, the ZS5Trainer of
    `train-zs5`, the Predictor of `infer`, the InferenceServer of `serve`
    once it stops, the DeepLab of `convert-weights`, the ExportedProgram of
    `export`; None for
    `show-config`, `prepare-context` and `build-embeddings`, which run on
    the host alone).  `show-config` returns the config's JSON text.
    `train-zs5` pseudo-labels the train set (the count goes to stderr),
    then trains.  The DATA_PARALLEL commands join the process group
    torchrun describes, if any (core/mesh.py::init_data_parallel)."""
    args = make_parser().parse_args(argv)
    cuda_build.set_build_dir(args.compilation_cache)
    cfg = build_config(args)
    if args.command in DATA_PARALLEL:
        from zs3_tpu_torch.core.mesh import init_data_parallel

        args.device = init_data_parallel(args.device)
    if getattr(args, "auto_resume", None):
        cfg = auto_resume(cfg, args.command)
    if args.command == "serve" and args.int8 and not args.calib_images:
        raise SystemExit("serve --int8 requires --calib-images")
    if args.command == "serve" and args.int8 and args.artifact:
        raise SystemExit("serve --int8 applies to checkpoint serving; for artifact "
                         "serving, export with --int8 instead")

    if args.command == "show-config":
        return cfg.to_json(), None
    if args.command == "profile":
        from zs3_tpu_torch.utils.profiling import profile_command

        return profile_command(cfg, args.mode, args.steps, args.trace_dir, args.device)
    if args.command == "convert-weights":
        return convert_weights(cfg, args.pth, args.output, args.force)
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
        if args.int8:
            import numpy as np
            from PIL import Image

            calib = [np.asarray(Image.open(p).convert("RGB")) for p in args.images[:8]]
            n_quant = predictor.quantize(calib, percentile=cfg.train.int8_percentile)
            print(f"int8: quantized {n_quant} convs", file=sys.stderr)
        written = predictor.predict_files(
            args.images, args.output, colorize=not args.no_color, sliding=args.sliding,
        )
        result = {"written": len(written), "output": args.output}
        if args.int8:
            result["int8_convs"] = n_quant
        return result, predictor
    if args.command == "serve":
        from zs3_tpu_torch.serve import InferenceServer

        server = InferenceServer(cfg, host=args.host, port=args.port, artifact=args.artifact,
                                 serve_batch=args.serve_batch, device=args.device,
                                 int8_calib_images=args.calib_images if args.int8 else None)
        print(json.dumps({"serving": f"http://{args.host}:{server.port}"}),
              file=sys.stderr, flush=True)
        try:
            server.serve_forever()
        finally:
            server.httpd.server_close()
        return {"served": f"http://{args.host}:{server.port}"}, server
    if args.command == "export":
        return export_command(cfg, args)
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


def export_command(cfg: Config, args: argparse.Namespace):
    """`cli export`: the artifact and its manifest written; returns
    ({"artifact", "bytes", **manifest}, the ExportedProgram)."""
    from zs3_tpu_torch.export import export_predictor, save_exported

    calib = None
    if args.int8:
        if not args.calib_images:
            raise SystemExit("export --int8 requires --calib-images")
        import numpy as np
        from PIL import Image

        calib = [np.asarray(Image.open(p).convert("RGB")) for p in args.calib_images]
    program, manifest = export_predictor(
        cfg, batch_size=args.export_batch, emit=args.emit,
        platforms=args.platforms.split(",") if args.platforms else None,
        allow_random=args.allow_random, int8_calib_images=calib, device=args.device,
    )
    size = save_exported(args.output, program, manifest)
    return {"artifact": args.output, "bytes": size, **manifest}, program


def convert_weights(cfg: Config, pth: str, output: str, force: bool):
    """`cli convert-weights`: the model of cfg.model, seeded from
    cfg.train.seed, with the upstream backbone at `pth` grafted in, saved
    as a checkpoint that `--resume output --ft` reads."""
    import os

    import torch

    from zs3_tpu_torch.models.deeplab import build_deeplab, init_deeplab
    from zs3_tpu_torch.utils.convert import load_pretrained_backbone

    if os.path.exists(output) and not force:
        raise SystemExit(f"convert-weights: output {output!r} already exists; "
                         f"pass --force to replace it")
    model = init_deeplab(build_deeplab(cfg.model), cfg.train.seed)
    load_pretrained_backbone(model, pth, cfg.model.backbone)
    directory = os.path.dirname(os.path.abspath(output))
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".{os.path.basename(output)}.{os.getpid()}")
    torch.save({"model": model.state_dict(), "step": 0}, tmp)
    os.replace(tmp, output)
    return ({"checkpoint": output,
             "usage": "pass via --resume with --ft for pretrained init"}, model)


def main(argv=None) -> int:
    import torch.distributed as dist

    from zs3_tpu_torch.core.mesh import world_size

    try:
        result, _ = run(argv)
        if world_size() == 1 or dist.get_rank() == 0:  # one line, from rank 0
            print(result if isinstance(result, str) else json.dumps(result))
    finally:
        if world_size() > 1:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
