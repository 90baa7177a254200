"""Both trainer CLIs' `--matmul-precision` on the CPU, through one helper
(`utils.misc.set_matmul_precision`, which the CLIs' shared `train.run.main`
calls): "highest" turns TF32 off in cuDNN and in matmuls, "high" allows it in
matmuls, "default" leaves PyTorch's flags as they are; the choice lands in
`config.json`. Training itself is stubbed out: only the CLI's parsing, flags
and run directory run."""

import json
from pathlib import Path

import pytest
import torch

from long_video_gan_tpu_torch import train_lres, train_sres
from long_video_gan_tpu_torch.train import run


@pytest.fixture
def restored_flags():
    """PyTorch's two flags as they were, put back after the test."""
    before = (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    try:
        yield before
    finally:
        torch.backends.cudnn.allow_tf32 = before[0]
        torch.set_float32_matmul_precision(before[1])


@pytest.mark.parametrize("cli", [train_lres, train_sres], ids=["train_lres", "train_sres"])
@pytest.mark.parametrize("precision", ["default", "high", "highest"])
def test_matmul_precision_flag(cli, precision, restored_flags, tmp_path, monkeypatch):
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("medium")
    trained = []
    monkeypatch.setattr(cli, "train", lambda *args: trained.append(args))
    run_dir = cli.main(["--dataset", str(tmp_path / "data"), "--outdir", str(tmp_path / "runs"),
                        "--preset", "tiny", "--batch", "4", "--device", "cpu",
                        "--matmul-precision", precision])
    assert len(trained) == 1
    config = json.loads(Path(run_dir, "config.json").read_text())
    assert config["matmul_precision"] == precision
    want = {"default": (True, "medium"), "high": (True, "high"),
            "highest": (False, "highest")}[precision]
    assert (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()) == want


def test_trainers_share_the_helper(tmp_path, monkeypatch):
    """Both CLIs set the precision through the one skeleton, `train.run.main`."""
    calls = []
    monkeypatch.setattr(run, "set_matmul_precision", calls.append)
    for cli in (train_lres, train_sres):
        monkeypatch.setattr(cli, "train", lambda *args: None)
        cli.main(["--dataset", str(tmp_path / "data"), "--outdir", str(tmp_path / cli.__name__),
                  "--preset", "tiny", "--batch", "4", "--device", "cpu",
                  "--matmul-precision", "high"])
    assert calls == ["high", "high"]
