"""Train, save, resume, generate: the port's lres trainer CLI at its `tiny`
preset on a synthetic dataset writes stats.jsonl, G_ema and train `.lvg`
checkpoints and sample videos; the JAX package's `load_generator` reads its
G_ema and both frameworks generate the same video from it; `--resume`
continues from a train checkpoint; the trainer runs with jax, flax and
msgpack unimportable; `--device cuda` without a card raises."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from long_video_gan_tpu.io import checkpoint as jax_checkpoint
from long_video_gan_tpu_torch.data.tools.synthetic import make_synthetic_dataset
from long_video_gan_tpu_torch.io.checkpoint import load_checkpoint, load_generator
from long_video_gan_tpu_torch.train_lres import main
from test_torch_lres_train import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_lres")
    make_synthetic_dataset(str(root / "data"), [(8, 16), (32, 64)], num_videos=3,
                           frames_per_video=20, num_partitions=1)
    run_dir = main(["--dataset", str(root / "data"), "--preset", "tiny", "--batch", "4",
                    "--outdir", str(root / "runs"), "--seed", "1", "--device", "cpu"])
    return root, run_dir


def test_cli_writes_stats_checkpoints_and_samples(run):
    _, run_dir = run
    records = [json.loads(line) for line in open(os.path.join(run_dir, "stats.jsonl"))]
    assert [r["step"] for r in records] == [2, 4]
    for r in records:
        for name in ("loss/G_loss", "loss/D_loss", "loss/r1_penalty", "progress/D_lrate"):
            assert np.isfinite(r[name]), name
    ckpts = sorted(os.listdir(os.path.join(run_dir, "checkpoints")))
    assert ckpts == sorted([f"ckpt-{s:08d}-G-ema.lvg" for s in (0, 2, 4)]
                           + [f"ckpt-{s:08d}-train.lvg" for s in (0, 4)])
    samples = sorted(os.listdir(os.path.join(run_dir, "samples")))
    assert samples == ["fake-00000000.mp4", "fake-00000002.mp4", "fake-00000004.mp4",
                       "real-long.mp4"]
    assert all(os.path.getsize(os.path.join(run_dir, "samples", s)) > 0 for s in samples)
    config = json.load(open(os.path.join(run_dir, "config.json")))
    assert config["gan_kwargs"]["G_random_temp_translate"] is True
    assert config["device"] == "cpu" and config["resume"] is None
    _, header = load_checkpoint(os.path.join(run_dir, "checkpoints", "ckpt-00000004-train.lvg"))
    assert header == {"step": 4}


def test_jax_loads_port_checkpoint_and_generates_the_same(run):
    _, run_dir = run
    path = os.path.join(run_dir, "checkpoints", "ckpt-00000004-G-ema.lvg")
    module_j, tree, config_j = jax_checkpoint.load_generator(path)
    G_t, config_t = load_generator(path)
    assert config_j == config_t and config_t["kind"] == "generator_lres"
    noise = np.random.default_rng(80).standard_normal(G_t.noise_shape(2, 16)).astype(np.float32)
    want = np.asarray(module_j.apply(tree, 2, 16, noise=jnp.asarray(noise)))
    with torch.no_grad():
        got = G_t(2, 16, noise=torch.from_numpy(noise)).numpy()
    assert got.shape == want.shape == (2, 3, 16, 8, 16)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * np.abs(want).max())


def test_cli_resumes_from_a_train_checkpoint(run):
    """--resume at step 4 with --total-steps 6: the run starts from that
    state (its step-4 G_ema checkpoint is the first run's) and trains on."""
    root, run_dir = run
    ckpt = os.path.join(run_dir, "checkpoints", "ckpt-00000004-train.lvg")
    resumed = main(["--dataset", str(root / "data"), "--preset", "tiny", "--batch", "4",
                    "--outdir", str(root / "runs"), "--seed", "1", "--device", "cpu",
                    "--resume", ckpt, "--total-steps", "6"])
    records = [json.loads(line) for line in open(os.path.join(resumed, "stats.jsonl"))]
    assert [r["step"] for r in records] == [6]
    ckpts = sorted(os.listdir(os.path.join(resumed, "checkpoints")))
    assert ckpts == ["ckpt-00000004-G-ema.lvg", "ckpt-00000004-train.lvg",
                     "ckpt-00000006-G-ema.lvg"]
    first, _ = load_checkpoint(os.path.join(run_dir, "checkpoints", "ckpt-00000004-G-ema.lvg"))
    again, _ = load_checkpoint(os.path.join(resumed, "checkpoints", "ckpt-00000004-G-ema.lvg"))
    last, _ = load_checkpoint(os.path.join(resumed, "checkpoints", "ckpt-00000006-G-ema.lvg"))
    leaf = lambda t: t["params"]["latent_mapping"]["layer_0"]["weight"]  # noqa: E731
    np.testing.assert_array_equal(leaf(again), leaf(first))
    assert not np.array_equal(leaf(last), leaf(first))
    assert json.load(open(os.path.join(resumed, "config.json")))["resume"] == ckpt


def test_cli_scores_each_g_ema_checkpoint(run, tmp_path, monkeypatch):
    """--metric fvd2048_16f with the stub detector scores the lres G_ema alone (the single-stage protocol) at each G_ema
    checkpoint: one JSON line per checkpoint in metric-fvd2048_16f.jsonl."""
    root, _ = run
    monkeypatch.setenv("LVG_CACHE_DIR", str(tmp_path / "cache"))
    run_dir = main(["--dataset", str(root / "data"), "--preset", "tiny", "--batch", "4",
                    "--outdir", str(tmp_path / "runs"), "--total-steps", "2", "--device", "cpu",
                    "-m", "fvd2048_16f", "--metric-detector", "stub:16", "--metric-items", "8"])
    records = [json.loads(line)
               for line in open(os.path.join(run_dir, "metric-fvd2048_16f.jsonl"))]
    assert [r["step"] for r in records] == [0, 2]
    assert all(r["metric"] == "fvd2048_16f" and np.isfinite(r["results"]["fvd2048_16f"])
               for r in records)
    config = json.load(open(os.path.join(run_dir, "config.json")))
    assert (config["metrics"], config["metric_detector"], config["metric_items"]) == (
        ["fvd2048_16f"], "stub:16", 8)
    assert os.listdir(tmp_path / "cache" / "long_video_gan_tpu_torch" / "metric_stats")

def test_cli_needs_cuda_unless_asked_for_cpu(run, tmp_path, monkeypatch):
    root, _ = run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--dataset", str(root / "data"), "--preset", "tiny", "--batch", "2",
              "--outdir", str(tmp_path / "runs")])
    assert not (tmp_path / "runs").exists()


def test_trainer_runs_without_jax_flax_msgpack(run):
    """The port's lres training path (the tiny CLI with R1, its train and
    G_ema checkpoints and samples, and `load_generator`) imports none of jax,
    flax or msgpack."""
    root, _ = run
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'msgpack', 'optax'):\n"
        "    sys.modules[name] = None\n"
        "import glob, os\n"
        "from long_video_gan_tpu_torch.train_lres import main\n"
        "from long_video_gan_tpu_torch.io.checkpoint import load_generator\n"
        f"run = main(['--dataset', {str(root / 'data')!r}, '--preset', 'tiny', '--batch', '2',"
        f" '--outdir', {str(root / 'blocked')!r}, '--total-steps', '2', '--device', 'cpu'])\n"
        "G, _ = load_generator(sorted(glob.glob(os.path.join(run, 'checkpoints', "
        "'*-G-ema.lvg')))[-1])\n"
        "assert glob.glob(os.path.join(run, 'checkpoints', '*-train.lvg'))\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'msgpack')"
        " and sys.modules[m] is not None]\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_trainer_runs_without_cv2_or_pil(run):
    """Without cv2 and PIL (and the JAX side), as on a machine with only
    torch and numpy, the CLI trains, writes its checkpoints and keeps each
    sample video as a uint8 [T, H, W, 3] `.npy` array."""
    root, _ = run
    code = (
        "import sys\n"
        "for name in ('cv2', 'PIL', 'jax', 'flax', 'msgpack', 'optax'):\n"
        "    sys.modules[name] = None\n"
        "from long_video_gan_tpu_torch.train_lres import main\n"
        f"print(main(['--dataset', {str(root / 'data')!r}, '--preset', 'tiny', '--batch', '2',"
        f" '--outdir', {str(root / 'no_video')!r}, '--total-steps', '2', '--device', 'cpu']))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    run_dir = out.stdout.strip().splitlines()[-1]
    assert sorted(os.listdir(os.path.join(run_dir, "checkpoints"))) == [
        "ckpt-00000000-G-ema.lvg", "ckpt-00000000-train.lvg", "ckpt-00000002-G-ema.lvg"]
    samples = sorted(os.listdir(os.path.join(run_dir, "samples")))
    assert samples == ["fake-00000000.mp4.npy", "fake-00000002.mp4.npy", "real-long.mp4.npy"]
    for name in samples:
        frames = np.load(os.path.join(run_dir, "samples", name))
        # 16 frames of one 8x16 clip, padded to a multiple of 16.
        assert frames.dtype == np.uint8 and frames.shape == (16, 16, 16, 3), name
