"""The port's host tools and CLIs on the CPU: cached URL fetching
(`utils/fetch.py`, as `tests/test_fetch.py` holds the JAX copy), `generate`
with `file://` checkpoints, `plot_color_similarity` (its histogram
intersection equal to the JAX tool's on seeded videos, and the CLI on tiny
generators), and `scripts/torch_learning_curve.py` over a run directory of
two G_ema checkpoints, whose FVDs equal the port's `calc_metrics` on the
same checkpoints, single-stage and two-stage."""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from long_video_gan_tpu_torch import calc_metrics, generate, plot_color_similarity
from long_video_gan_tpu_torch.data.tools.synthetic import make_synthetic_dataset
from long_video_gan_tpu_torch.io.checkpoint import save_generator
from long_video_gan_tpu_torch.models import generator_lres, generator_sres
from long_video_gan_tpu_torch.models.common import init_weights_
from long_video_gan_tpu_torch.utils.fetch import (default_cache_dir, fetch_url, is_url,
                                                  resolve_path)
from test_torch_generate import LRES_KW, SRES_KW
from test_torch_lres_train import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import torch_learning_curve  # noqa: E402


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """A run directory of two tiny lres G_ema checkpoints (steps 0 and 2,
    seeded weights) with its config.json, a tiny sres G_ema beside it, and a
    synthetic dataset of 20-frame videos at 8x16 and 32x64."""
    root = tmp_path_factory.mktemp("host_clis")
    make_synthetic_dataset(str(root / "data"), [(8, 16), (32, 64)], num_videos=3,
                           frames_per_video=20, num_partitions=1)
    (root / "run" / "checkpoints").mkdir(parents=True)
    gen = torch.Generator().manual_seed(51)
    for step in (0, 2):
        save_generator(str(root / "run" / "checkpoints" / f"ckpt-{step:08d}-G-ema.lvg"),
                       init_weights_(generator_lres.VideoGenerator(**LRES_KW), gen),
                       dict(kind="generator_lres", kwargs=LRES_KW))
    save_generator(str(root / "sres.lvg"),
                   init_weights_(generator_sres.VideoGenerator(**SRES_KW), gen),
                   dict(kind="generator_sres", kwargs=SRES_KW))
    (root / "run" / "config.json").write_text(json.dumps(
        dict(dataset_dir=str(root / "data"), height=8, width=16)))
    # A run of one checkpoint, for the two-stage curve (its sres G is slow).
    (root / "run1" / "checkpoints").mkdir(parents=True)
    (root / "run1" / "checkpoints" / "ckpt-00000002-G-ema.lvg").write_bytes(
        (root / "run" / "checkpoints" / "ckpt-00000002-G-ema.lvg").read_bytes())
    (root / "run1" / "config.json").write_text((root / "run" / "config.json").read_text())
    return root


# ---------------------------------------------------------------- utils/fetch


def test_file_url_fetch_and_cache(tmp_path):
    src = tmp_path / "payload.bin"
    src.write_bytes(b"\x00\x01payload\xff" * 100)
    url = src.as_uri()
    cache = str(tmp_path / "cache")

    p1 = fetch_url(url, cache_dir=cache, verbose=False)
    assert pathlib.Path(p1).read_bytes() == src.read_bytes()
    assert p1.startswith(cache)
    assert p1.endswith("payload.bin")

    # Cache hit: the source may vanish, the fetch still succeeds.
    src.unlink()
    p2 = fetch_url(url, cache_dir=cache, verbose=False)
    assert p2 == p1 and os.path.isfile(p2)


def test_resolve_path_passthrough(tmp_path):
    local = str(tmp_path / "x.lvg")
    assert resolve_path(local) == local
    assert not is_url(local)
    assert is_url("https://example.com/a.pkl")
    with pytest.raises(ValueError, match="not a URL"):
        fetch_url(local)


def test_fetch_failure_raises(tmp_path):
    url = (tmp_path / "missing.bin").as_uri()
    with pytest.raises(RuntimeError, match="failed to fetch"):
        fetch_url(url, cache_dir=str(tmp_path / "c"), num_attempts=2, verbose=False)


def test_cache_is_apart_from_the_jax_package(tmp_path, monkeypatch):
    from long_video_gan_tpu.utils import fetch as jax_fetch

    monkeypatch.setenv("LVG_CACHE_DIR", str(tmp_path))
    assert default_cache_dir() == str(tmp_path / "long_video_gan_tpu_torch" / "downloads")
    assert default_cache_dir() != jax_fetch.DEFAULT_CACHE_DIR
    src = tmp_path / "a.bin"
    src.write_bytes(b"abc")
    assert resolve_path(src.as_uri()).startswith(default_cache_dir())


# ------------------------------------------------------------------ generate


def test_generate_takes_file_urls(env, tmp_path, monkeypatch):
    monkeypatch.setenv("LVG_CACHE_DIR", str(tmp_path / "cache"))
    lres = env / "run" / "checkpoints" / "ckpt-00000002-G-ema.lvg"
    args = ["--frames", "6", "--segment-length", "4", "--save-frames", "--device", "cpu"]
    generate.main(["--lres", str(lres), "--sres", str(env / "sres.lvg"),
                   "--output", str(tmp_path / "local.mp4"), *args])
    generate.main(["--lres", lres.as_uri(), "--sres", (env / "sres.lvg").as_uri(),
                   "--output", str(tmp_path / "url.mp4"), *args])
    frames = sorted(p.name for p in (tmp_path / "local").iterdir())
    assert len(frames) == 6 and frames == sorted(p.name for p in (tmp_path / "url").iterdir())
    for name in frames:
        assert (tmp_path / "url" / name).read_bytes() == (tmp_path / "local" / name).read_bytes()
    cached = sorted(os.listdir(default_cache_dir()))
    assert sorted(c.split("-", 1)[1] for c in cached) == ["ckpt-00000002-G-ema.lvg", "sres.lvg"]


# ------------------------------------------------------ plot_color_similarity


def _jax_plot_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_plot_color_similarity", os.path.join(REPO, "plot_color_similarity.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_video_color_intersection_matches_jax():
    jax_tool = _jax_plot_tool()
    rng = np.random.default_rng(61)
    videos = [np.clip(rng.standard_normal((3, 9, 12, 20)) * 0.6 + rng.uniform(-0.5, 0.5), -1, 1)
              .astype(np.float32) for _ in range(4)]
    for video in videos:
        for bins in (4, 20):
            got = plot_color_similarity.video_color_intersection(video, bins)
            want = jax_tool.video_color_intersection(video, bins)
            assert got.shape == (8,) and np.array_equal(got, want)
    got = plot_color_similarity.accumulate(videos)
    want = jax_tool._accumulate(videos)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_plot_cli_on_tiny_generators(env, tmp_path, one_torch_thread):  # noqa: F811
    lres = env / "run" / "checkpoints" / "ckpt-00000002-G-ema.lvg"
    plot_color_similarity.main(["--path", str(tmp_path / "fig.png"), "--dataset",
                                str(env / "data"), "--lres", str(lres), "--sres",
                                str(env / "sres.lvg"), "--len", "8", "--samples", "3",
                                "--batch", "2", "--device", "cpu"])
    assert (tmp_path / "fig.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    lres_G = generator_lres.VideoGenerator(**LRES_KW).eval()
    videos = list(plot_color_similarity.generated_videos(lres_G, None, 3, 2, 9, "cpu"))
    assert len(videos) == 4 and videos[0].shape == (3, 9, 8, 16)


# --------------------------------------------------------- the learning curve


@pytest.mark.parametrize("two_stage", [False, True])
def test_learning_curve_equals_calc_metrics(env, tmp_path, monkeypatch, capsys, two_stage,
                                            one_torch_thread):  # noqa: F811
    """Every checkpoint's FVD (stub detector) equals calc_metrics' on it:
    lres-only over the two-checkpoint run, two-stage over a run of one (the
    sres G is the slow part)."""
    monkeypatch.setenv("LVG_CACHE_DIR", str(tmp_path / "cache"))
    run = env / ("run1" if two_stage else "run")
    (run / "metric-curve.jsonl").unlink(missing_ok=True)
    items = "4" if two_stage else "8"
    extra = ["--sres", str(env / "sres.lvg"), "--height", "32", "--width", "64"] if two_stage \
        else []
    records = torch_learning_curve.main(["--run-dir", str(run), "--detector", "stub:16",
                                         "--items", items, "--device", "cpu", *extra])
    assert [r["step"] for r in records] == ([2] if two_stage else [0, 2])
    lines = [json.loads(line) for line in open(run / "metric-curve.jsonl")]
    assert lines == records
    assert "fvd" in capsys.readouterr().out
    if not two_stage:
        assert records[0]["fvd"] != records[1]["fvd"]
    for record in records:
        ckpt = run / "checkpoints" / f"ckpt-{record['step']:08d}-G-ema.lvg"
        (result,) = calc_metrics.main(
            ["-m", "fvd2048_16f", "--lres", str(ckpt), "--dataset", str(env / "data"),
             "--detector", "stub:16", "--max-items", items, "--device", "cpu", *extra[:2]])
        assert np.isfinite(record["fvd"])
        assert record["fvd"] == pytest.approx(result["results"]["fvd2048_16f"], rel=1e-6)


def test_new_modules_import_without_jax(tmp_path):
    """With jax, flax, msgpack, click and the JAX package unimportable, every
    module and script this slice adds imports."""
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'msgpack', 'long_video_gan_tpu', 'click'):\n"
        "    sys.modules[name] = None\n"
        f"sys.path.insert(0, {os.path.join(REPO, 'scripts')!r})\n"
        "from long_video_gan_tpu_torch import (bench_train, convert_checkpoint,\n"
        "                                      plot_color_similarity)\n"
        "from long_video_gan_tpu_torch.utils import fetch, profiling\n"
        "from long_video_gan_tpu_torch.io import convert_torch\n"
        "from long_video_gan_tpu_torch.data.tools import (common, make_dataset_from_frames,\n"
        "    make_dataset_from_videos, make_dataset_from_youtube)\n"
        "import torch_bench_layers, torch_bench_prefetch, torch_bench_train_sweep\n"
        "import torch_learning_curve, torch_profile_train\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'msgpack',"
        " 'long_video_gan_tpu', 'click') and sys.modules[m] is not None]\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(tmp_path),
                         env=dict(os.environ, PYTHONPATH=REPO, LVG_CACHE_DIR=str(tmp_path),
                                  OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
