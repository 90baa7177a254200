"""Train, save, generate: the port's sres trainer CLI at its `tiny` preset on a
synthetic dataset writes stats.jsonl and G_ema `.lvg` checkpoints; the JAX
package's `load_generator` reads one and both frameworks generate the same
segment from it. The `.lvg` writer's msgpack encoder gives flax's bytes, and
the trainer runs with jax, flax and msgpack unimportable."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import serialization

from long_video_gan_tpu.io import checkpoint as jax_checkpoint
from long_video_gan_tpu.models import generator_sres as jax_sres
from long_video_gan_tpu_torch.data.jpeg import decoder_in_use
from long_video_gan_tpu_torch.data.tools.synthetic import make_synthetic_dataset
from long_video_gan_tpu_torch.io.checkpoint import load_checkpoint, load_generator
from long_video_gan_tpu_torch.io.convert_torch import load_jax_variables, module_to_variables
from long_video_gan_tpu_torch.io.msgpack_encode import packb
from long_video_gan_tpu_torch.models import generator_lres, generator_sres
from long_video_gan_tpu_torch.train_sres import main
from test_torch_generators import LRES_KW, random_variables
from test_torch_lres_train import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_sres")
    make_synthetic_dataset(str(root / "data"), [(8, 16), (32, 64)], num_videos=3,
                           frames_per_video=20, num_partitions=1)
    run_dir = main(["--dataset", str(root / "data"), "--preset", "tiny", "--batch", "4",
                    "--outdir", str(root / "runs"), "--seed", "1", "--device", "cpu"])
    return root, run_dir


def test_cli_writes_stats_and_checkpoints(run):
    _, run_dir = run
    records = [json.loads(line) for line in open(os.path.join(run_dir, "stats.jsonl"))]
    assert [r["step"] for r in records] == [2, 4]
    for r in records:
        for name in ("loss/G_loss", "loss/D_loss", "loss/r1_penalty", "progress/augment_p"):
            assert np.isfinite(r[name]), name
    ckpts = sorted(os.listdir(os.path.join(run_dir, "checkpoints")))
    assert ckpts == sorted([f"ckpt-{s:08d}-G-ema.lvg" for s in (0, 2, 4)]
                           + [f"ckpt-{s:08d}-train.lvg" for s in (0, 4)])
    assert sorted(os.listdir(os.path.join(run_dir, "samples"))) == (
        [f"fake-{s:08d}-hr.mp4" for s in (0, 2, 4)] + ["real-hr.mp4", "real-lr.mp4"])
    config = json.load(open(os.path.join(run_dir, "config.json")))
    assert config["gan_kwargs"]["G_kwargs"]["resample_impl"] == "auto"
    assert config["jpeg_decoder"] == decoder_in_use() and config["jpeg_decoder"].startswith(
        "native (")
    # G_ema moved between the first and the last checkpoint.
    first, _ = load_checkpoint(os.path.join(run_dir, "checkpoints", "ckpt-00000000-G-ema.lvg"))
    last, _ = load_checkpoint(os.path.join(run_dir, "checkpoints", "ckpt-00000004-G-ema.lvg"))
    leaf = lambda t: t["params"]["SG3"]["mapping"]["fc0"]["weight"]  # noqa: E731
    assert not np.array_equal(leaf(first), leaf(last))


def test_cli_resumes_from_a_train_checkpoint(run):
    """--resume at step 4 with --total-steps 6: the run starts from that
    state (its step-4 G_ema checkpoint and its ADA p are the first run's)
    and trains on."""
    from long_video_gan_tpu_torch.train_sres import make_gan
    from long_video_gan_tpu_torch.train.state import load_train_checkpoint

    root, run_dir = run
    ckpt = os.path.join(run_dir, "checkpoints", "ckpt-00000004-train.lvg")
    resumed = main(["--dataset", str(root / "data"), "--preset", "tiny", "--batch", "4",
                    "--outdir", str(root / "runs"), "--seed", "1", "--device", "cpu",
                    "--resume", ckpt, "--total-steps", "6"])
    records = [json.loads(line) for line in open(os.path.join(resumed, "stats.jsonl"))]
    assert [r["step"] for r in records] == [6]
    assert sorted(os.listdir(os.path.join(resumed, "checkpoints"))) == [
        "ckpt-00000004-G-ema.lvg", "ckpt-00000004-train.lvg", "ckpt-00000006-G-ema.lvg"]
    first, _ = load_checkpoint(os.path.join(run_dir, "checkpoints", "ckpt-00000004-G-ema.lvg"))
    again, _ = load_checkpoint(os.path.join(resumed, "checkpoints", "ckpt-00000004-G-ema.lvg"))
    leaf = lambda t: t["params"]["SG3"]["mapping"]["fc0"]["weight"]  # noqa: E731
    np.testing.assert_array_equal(leaf(again), leaf(first))
    config = json.load(open(os.path.join(resumed, "config.json")))
    gan = make_gan(config, torch.device("cpu"))
    assert load_train_checkpoint(ckpt, gan)["step"] == gan.step == 4
    tree, _ = load_checkpoint(os.path.join(resumed, "checkpoints", "ckpt-00000004-train.lvg"))
    np.testing.assert_array_equal(tree["ada_p"], gan.ada_p.numpy())


def test_jax_loads_port_checkpoint_and_generates_the_same(run):
    _, run_dir = run
    path = os.path.join(run_dir, "checkpoints", "ckpt-00000004-G-ema.lvg")
    module_j, tree, config_j = jax_checkpoint.load_generator(path)
    G_t, config_t = load_generator(path)
    assert config_j == config_t and config_t["kind"] == "generator_sres"
    rng = np.random.default_rng(50)
    lr = rng.uniform(-1, 1, (2, 3, 6, 8, 16)).astype(np.float32)
    z = rng.standard_normal((2, 32)).astype(np.float32)
    want = np.asarray(module_j.apply(tree, jnp.asarray(lr), z=jnp.asarray(z)))
    with torch.no_grad():
        got = G_t(torch.from_numpy(lr), z=torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (2, 3, 2, 32, 64)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * np.abs(want).max())


@pytest.mark.parametrize("kind", ["generator_sres", "generator_lres"])
def test_module_to_variables_round_trip(kind, tmp_path):
    """port -> flax tree -> `.lvg` -> flax (JAX reader) and port (port reader)."""
    if kind == "generator_sres":
        kw = dict(hr_height=32, hr_width=64, lr_height=8, lr_width=16, temporal_context=2,
                  latent_z_dim=32, latent_w_dim=32, margin_size=4, num_fp16_res=0,
                  channel_base=1024, channel_max=32, num_layers=6, fourfeats=True)
        G_j = jax_sres.VideoGenerator(**kw)
        variables = random_variables(G_j, jnp.zeros((1, 3, 6, 8, 16)), seed=51)
        G_t = generator_sres.VideoGenerator(**kw)
    else:
        from long_video_gan_tpu.models import generator_lres as jax_lres

        kw = LRES_KW
        variables = random_variables(jax_lres.VideoGenerator(**kw), 1, 8, seed=52)
        G_t = generator_lres.VideoGenerator(**kw)
    load_jax_variables(G_t, variables)
    tree = module_to_variables(G_t)
    assert set(tree) == set(variables)
    want = jax.tree_util.tree_flatten_with_path(variables)[0]
    got = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    from long_video_gan_tpu_torch.io.checkpoint import save_generator

    save_generator(str(tmp_path / "g.lvg"), G_t, dict(kind=kind, kwargs=kw))
    _, tree_j, _ = jax_checkpoint.load_generator(str(tmp_path / "g.lvg"))
    G_back, _ = load_generator(str(tmp_path / "g.lvg"))
    for key, value in G_t.state_dict().items():
        torch.testing.assert_close(G_back.state_dict()[key], value, rtol=0, atol=0)
    assert jax.tree_util.tree_structure(tree_j) == jax.tree_util.tree_structure(variables)


def test_msgpack_encoder_writes_flax_bytes():
    rng = np.random.default_rng(53)
    tree = {"params": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                       "b": {"c": np.float32(1.5), "e": np.ones((), np.float32),
                             "i": np.arange(5, dtype=np.int32)}},
            "ema": {f"m{i}": np.full((i % 3 + 1,), i, np.float32) for i in range(20)},
            "big": np.zeros((70_000,), np.float32)}
    assert packb(tree) == serialization.msgpack_serialize(tree)
    import msgpack

    values = [0, 127, 128, 65536, 2 ** 40, -1, -33, -129, -40_000, -2 ** 40, 1.5, "s" * 31,
              "t" * 300, "u" * 70_000, b"b" * 300, None, True, False, list(range(20)),
              dict(sorted((str(i), i) for i in range(20)))]     # flax's maps come sorted
    for v in values:
        assert packb(v) == msgpack.packb(v, use_bin_type=True)


def test_cli_scores_each_g_ema_checkpoint(run, tmp_path, monkeypatch):
    """--metric fvd2048_16f with the stub detector scores the sres G_ema on real lr clips of the dataset (the cond-dataset protocol) at each G_ema
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
    """`--device` defaults to cuda: with no CUDA device and no `--device`, the
    trainer CLI raises before it makes its run directory; the module's run
    (`--device cpu`) trained."""
    root, run_dir = run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--dataset", str(root / "data"), "--preset", "tiny", "--batch", "2",
              "--outdir", str(tmp_path / "runs")])
    assert not (tmp_path / "runs").exists()
    assert json.load(open(os.path.join(run_dir, "config.json")))["device"] == "cpu"


def test_trainer_runs_without_jax_flax_msgpack(run):
    """The port's training path (the tiny CLI, the `.lvg` writer and reader)
    imports none of jax, flax or msgpack."""
    root, _ = run
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'msgpack', 'optax'):\n"
        "    sys.modules[name] = None\n"
        "import glob, os\n"
        "from long_video_gan_tpu_torch.train_sres import main\n"
        "from long_video_gan_tpu_torch.io.checkpoint import load_generator\n"
        f"run = main(['--dataset', {str(root / 'data')!r}, '--preset', 'tiny', '--batch', '2',"
        f" '--outdir', {str(root / 'blocked')!r}, '--total-steps', '2', '--device', 'cpu'])\n"
        "G, _ = load_generator(sorted(glob.glob(os.path.join(run, 'checkpoints', '*.lvg')))[-1])\n"
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
        "from long_video_gan_tpu_torch.train_sres import main\n"
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
    assert samples == ["fake-00000000-hr.mp4.npy", "fake-00000002-hr.mp4.npy",
                       "real-hr.mp4.npy", "real-lr.mp4.npy"]
    for name in samples:
        frames = np.load(os.path.join(run_dir, "samples", name))
        assert frames.dtype == np.uint8 and frames.ndim == 4 and frames.shape[-1] == 3, name
