"""The port's metric CLI, `python -m long_video_gan_tpu_torch.calc_metrics`:
tiny `.lvg` generators on a synthetic dataset through the two-stage and the
lres-only pipeline on `--device cpu`, JSON lines printed and appended to
`--output`; raising without CUDA unless asked for the CPU; and the metric
path (CLI, native detector converted from a scripted file, dataset tool)
running with jax, flax and the JAX package unimportable."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from long_video_gan_tpu_torch.calc_metrics import main
from long_video_gan_tpu_torch.data.tools.synthetic import make_synthetic_dataset
from long_video_gan_tpu_torch.io.checkpoint import save_generator
from long_video_gan_tpu_torch.models import generator_lres, generator_sres
from long_video_gan_tpu_torch.models.common import init_weights_
from test_torch_generate import LRES_KW, SRES_KW
from test_torch_lres_train import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Tiny lres and sres G_ema checkpoints with seeded random weights,
    written by the port, and a synthetic dataset of 20-frame videos."""
    root = tmp_path_factory.mktemp("calc_metrics")
    make_synthetic_dataset(str(root / "data"), [(8, 16), (32, 64)], num_videos=3,
                           frames_per_video=20, num_partitions=1)
    gen = torch.Generator().manual_seed(41)
    for kind, cls, kw in (("lres", generator_lres.VideoGenerator, LRES_KW),
                          ("sres", generator_sres.VideoGenerator, SRES_KW)):
        save_generator(str(root / f"{kind}.lvg"), init_weights_(cls(**kw), gen),
                       dict(kind=f"generator_{kind}", kwargs=kw))
    return root


def _args(root, *extra):
    return ["--lres", str(root / "lres.lvg"), "--dataset", str(root / "data"),
            "--detector", "stub:16", "--max-items", "8", *extra]


def test_cli_two_stage_and_lres_only(env, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("LVG_CACHE_DIR", str(tmp_path / "cache"))
    out = tmp_path / "out" / "metrics.jsonl"
    results = main(_args(env, "--sres", str(env / "sres.lvg"), "-m", "fvd2048_16f",
                         "--output", str(out), "--device", "cpu"))
    results += main(_args(env, "--metric", "fid50k_full", "--output", str(out),
                          "--device", "cpu"))
    lines = [json.loads(line) for line in open(out)]
    assert [r["metric"] for r in lines] == ["fvd2048_16f", "fid50k_full"]
    assert [r["sres"] is not None for r in lines] == [True, False]
    for r, result in zip(lines, results):
        assert r["results"] == result["results"]
        assert all(np.isfinite(v) for v in r["results"].values())
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert printed == lines


def test_cli_needs_cuda_unless_asked_for_cpu(env, tmp_path, monkeypatch):
    monkeypatch.setenv("LVG_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "metrics.jsonl"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(_args(env, "-m", "fvd2048_16f", "--output", str(out)))
    assert not out.exists()
    main(_args(env, "-m", "fvd2048_16f", "--output", str(out), "--device", "cpu"))
    assert out.is_file()


def test_metrics_run_without_jax_flax(env, tmp_path):
    """With jax, flax, msgpack and the JAX package unimportable: a dataset
    made with the port's tool, the port's I3D scripted to a file and loaded
    back through `get_detector("i3d:<path>")` (native conversion), and the
    CLI computing a metric through that detector."""
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'msgpack', 'long_video_gan_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np, torch\n"
        "from long_video_gan_tpu_torch.calc_metrics import main\n"
        "from long_video_gan_tpu_torch.data.tools.synthetic import make_synthetic_dataset\n"
        "from long_video_gan_tpu_torch.metrics.detectors import get_detector\n"
        "from long_video_gan_tpu_torch.metrics.i3d import I3DDetector, InceptionI3d\n"
        "from long_video_gan_tpu_torch.models.common import init_weights_\n"
        f"root = {str(tmp_path)!r}\n"
        "make_synthetic_dataset(root + '/data', [(8, 16)], num_videos=2, frames_per_video=8,\n"
        "                       num_partitions=1)\n"
        "i3d = InceptionI3d().eval()\n"
        "with torch.no_grad():\n"
        "    torch.jit.trace(i3d, torch.zeros(1, 3, 8, 32, 32)).save(root + '/i3d.pt')\n"
        "det = get_detector('i3d:' + root + '/i3d.pt', 'cpu')\n"
        "assert isinstance(det, I3DDetector)\n"
        "assert det(np.zeros((1, 3, 8, 32, 32), np.uint8)).shape == (1, 400)\n"
        f"r = main(['--lres', {str(env / 'lres.lvg')!r}, '--dataset', root + '/data',\n"
        "          '-m', 'fid50k_full', '--max-items', '4', '--detector', 'stub:8',\n"
        "          '--device', 'cpu'])\n"
        "assert np.isfinite(r[0]['results']['fid50k_full'])\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'msgpack',"
        " 'long_video_gan_tpu') and sys.modules[m] is not None]\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                                  LVG_CACHE_DIR=str(tmp_path / "cache")))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
