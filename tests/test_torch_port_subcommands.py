"""`cli convert-weights`: an upstream-named backbone .pth grafted into the
port's model from the flags, written as a checkpoint that `--resume ...
--ft` reads, for the new backbones and a torchvision-named ResNet-50.
torch only (tests/test_torch_port_backbones.py holds the grafted
backbones against the oracles' and zs3_tpu's outputs)."""

import json

import pytest
import torch

from tests.test_torch_parity import _randomize_bn_stats
from tests.torch_port_threads import torch_one_thread  # noqa: F401 (autouse)
from zs3_tpu_torch import cli
from zs3_tpu_torch.utils.saver import Saver

FLAGS = ["--dataset", "synthetic", "--crop-size", "33", "--base-size", "33",
         "--compute-dtype", "float32", "--unseen-split", "2", "--device", "cpu"]


def _upstream(backbone):
    from tests.torch_oracle import ResNetAtrous
    from tests.torch_oracle_backbones import TorchAlignedXception, TorchDRN54, TorchMobileNetV2

    torch.manual_seed(4)
    model = {"xception": TorchAlignedXception, "mobilenet": TorchMobileNetV2, "drn": TorchDRN54,
             "resnet50": lambda: ResNetAtrous(layers=(3, 4, 6, 3))}[backbone]()
    with torch.no_grad():
        _randomize_bn_stats(model, seed=5)
    state = dict(model.state_dict())
    if backbone == "resnet50":  # torchvision's classifier head
        state.update({"fc.weight": torch.zeros(1000, 2048), "fc.bias": torch.zeros(1000)})
    return state


@pytest.mark.parametrize("backbone", ["mobilenet", "resnet50"])
def test_convert_weights_then_evaluate(backbone, tmp_path, capsys):
    state = _upstream(backbone)
    pth, out = tmp_path / f"{backbone}.pth", tmp_path / "init.pt"
    torch.save(state, pth)
    flags = [*FLAGS, "--backbone", backbone, "--checkpoint-dir", str(tmp_path / "run")]
    assert cli.main(["convert-weights", str(pth), "--output", str(out), *flags]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result == {"checkpoint": str(out),
                      "usage": "pass via --resume with --ft for pretrained init"}
    saved = Saver.restore(str(out))["model"]
    for key, value in state.items():
        if not key.startswith("fc."):
            assert torch.equal(saved[f"backbone.{key}"], value), key
    with pytest.raises(SystemExit, match="--force"):
        cli.run(["convert-weights", str(pth), "--output", str(out), *flags])
    cli.run(["convert-weights", str(pth), "--output", str(out), "--force", "--seed", "3",
             *flags])

    report, trainer = cli.run(["evaluate", "--resume", str(out), "--ft", *flags])
    assert 0.0 <= report["miou"] <= 1.0 and "harmonic_miou" in report
    for key, value in state.items():
        if not key.startswith("fc."):
            assert torch.equal(trainer.model.state_dict()[f"backbone.{key}"], value), key


def test_convert_weights_refuses_another_backbones_file(tmp_path):
    pth = tmp_path / "drn.pth"
    torch.save(_upstream("drn"), pth)
    with pytest.raises(ValueError, match="unexpected key 'layer0.0.weight'"):
        cli.run(["convert-weights", str(pth), "--output", str(tmp_path / "x.pt"),
                 "--backbone", "mobilenet", *FLAGS])
    assert not (tmp_path / "x.pt").exists()


def test_every_subcommand_takes_every_backbone():
    parser = cli.make_parser()
    commands = parser._subparsers._group_actions[0].choices
    assert {"show-config", "profile", "convert-weights"} <= set(commands)
    for name, sub in commands.items():
        backbone = next(a for a in sub._actions if a.dest == "backbone")
        assert set(backbone.choices) >= {"resnet101", "resnet50", "xception", "mobilenet", "drn"}
    args = parser.parse_args(["profile", "--backbone", "drn", "--mode", "int8-fwd"])
    assert (args.steps, args.trace_dir, args.mode) == (10, None, "int8-fwd")
    assert cli.build_config(args).model.backbone == "drn"
