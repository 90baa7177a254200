"""The port's slice as a whole: two tiny `.lvg` checkpoints written by the JAX
package go through `long_video_gan_tpu_torch.generate`, against the JAX
pipeline of `generate.py` reproduced here with the same injected lres noise
and sres z; the port's CLI; and the port running with jax, flax and msgpack
unimportable."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from long_video_gan_tpu.io.checkpoint import save_generator
from long_video_gan_tpu.models import generator_lres as jax_lres
from long_video_gan_tpu.models import generator_sres as jax_sres
from long_video_gan_tpu_torch.generate import generate_video, lres_length, main
from long_video_gan_tpu_torch.io.checkpoint import load_generator
from test_torch_generators import random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Sizes of tests/test_generate_cli.py: the lres output is the sres input.
LRES_KW = dict(out_height=8, out_width=16, temporal_emb_dim=64, latent_w_dim=64,
               temporal_padding=2, channel_max=32,
               embedding_kwargs=dict(min_sampling_rate=10, max_sampling_rate=40, blur_widths=16))
SRES_KW = dict(hr_height=32, hr_width=64, lr_height=8, lr_width=16, temporal_context=2,
               latent_z_dim=32, latent_w_dim=32, margin_size=4, num_fp16_res=0,
               channel_base=1024, channel_max=32, num_layers=6, resample_impl="auto")


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("generate_lvg")
    G_l = jax_lres.VideoGenerator(**LRES_KW)
    v_l = random_variables(G_l, 1, 8, seed=21)
    save_generator(str(root / "lres.lvg"), v_l, dict(kind="generator_lres", kwargs=LRES_KW))
    G_s = jax_sres.VideoGenerator(**SRES_KW)
    v_s = random_variables(G_s, jnp.zeros((1, 3, 8, 8, 16)), seed=22)
    save_generator(str(root / "sres.lvg"), v_s, dict(kind="generator_sres", kwargs=SRES_KW))
    return root, (G_l, v_l), (G_s, v_s)


def _jax_generate(lres, sres, noise, z, num_frames, segment_length):
    """generate.py:68-128 with injected noise and z."""
    (G_l, v_l), (G_s, v_s) = lres, sres
    lr_len = lres_length(num_frames, segment_length, G_s.temporal_context)
    lr_video = G_l.apply(v_l, noise.shape[0], lr_len, noise=jnp.asarray(noise))
    apply_fn = jax.jit(lambda v, w, z: G_s.apply(v, w, z=z))
    segs = [np.asarray(s) for s in jax_sres.sample_video_segments(
        apply_fn, v_s, lr_video, segment_length=segment_length,
        temporal_context=G_s.temporal_context, z=jnp.asarray(z))]
    return np.concatenate(segs, axis=2)[:, :, :num_frames]


def test_generate_video_matches_jax_pipeline(checkpoints):
    root, lres, sres = checkpoints
    lres_G, _ = load_generator(str(root / "lres.lvg"), "cpu")
    sres_G, _ = load_generator(str(root / "sres.lvg"), "cpu")
    num_frames, segment, batch = 7, 4, 2
    rng = np.random.default_rng(23)
    noise = rng.standard_normal(lres_G.noise_shape(
        batch, lres_length(num_frames, segment, sres_G.temporal_context))).astype(np.float32)
    z = rng.standard_normal((batch, 32)).astype(np.float32)
    want = _jax_generate(lres, sres, noise, z, num_frames, segment)

    segs = list(generate_video(lres_G, sres_G, num_frames, segment_length=segment,
                               batch_size=batch, generator=torch.Generator(),
                               device=torch.device("cpu"), noise=torch.from_numpy(noise),
                               z=torch.from_numpy(z)))
    assert [s.shape[2] for s in segs] == [4, 3]
    got = torch.cat(segs, dim=2).numpy()
    assert got.shape == want.shape == (batch, 3, num_frames, 32, 64)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-3)


def test_generate_video_seeded_draws(checkpoints):
    root = checkpoints[0]
    lres_G, _ = load_generator(str(root / "lres.lvg"))
    sres_G, _ = load_generator(str(root / "sres.lvg"))

    def run(seed):
        return torch.cat(list(generate_video(
            lres_G, sres_G, 4, segment_length=4, generator=torch.Generator().manual_seed(seed),
            device=torch.device("cpu"))), dim=2)

    a, b, c = run(5), run(5), run(6)
    assert a.shape == (1, 3, 4, 32, 64) and bool(torch.isfinite(a).all())
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)


def test_cli_writes_videos_and_frames(checkpoints, tmp_path):
    root = checkpoints[0]
    out = tmp_path / "video.mp4"
    main(["--lres", str(root / "lres.lvg"), "--sres", str(root / "sres.lvg"),
          "--output", str(out), "--frames", "5", "--segment-length", "4", "--seed", "7",
          "--device", "cpu", "--save-lres", "--save-frames", "--save-index", "0",
          "-i", "3", "--save-index", "99"])
    assert out.is_file() and out.stat().st_size > 0
    assert (tmp_path / "video-lres.mp4").is_file()
    frames = sorted((tmp_path / "video").glob("*.png"))
    assert [p.name for p in frames] == [f"{i:06d}.png" for i in range(5)]
    assert (tmp_path / "video-frame0000.png").is_file()
    assert (tmp_path / "video-frame0003.png").is_file()
    assert not (tmp_path / "video-frame0099.png").exists()

    lres_only = tmp_path / "lres_only" / "v.mp4"
    main(["--lres", str(root / "lres.lvg"), "--output", str(lres_only), "--frames", "6",
          "--device", "cpu", "-i", "1"])
    assert (lres_only.parent / "v-lres.mp4").is_file() and not lres_only.exists()
    assert (lres_only.parent / "v-frame0001.png").is_file()


def test_cli_needs_cuda_unless_asked_for_cpu(checkpoints, tmp_path, monkeypatch):
    """`--device` defaults to cuda: with no CUDA device and no `--device`, the
    CLI raises before it loads or writes anything; `--device cpu` runs."""
    root = checkpoints[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "nocuda" / "v.mp4"
    args = ["--lres", str(root / "lres.lvg"), "--output", str(out), "--frames", "2"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(args)
    assert not out.parent.exists()
    main(args + ["--device", "cpu"])
    assert (out.parent / "v-lres.mp4").is_file()


def test_port_runs_without_jax_flax_msgpack(checkpoints, tmp_path):
    """The port imports none of jax, flax, msgpack or the JAX package: with
    them unimportable it loads both checkpoints and generates, runs the
    generate CLI with video writing and `--save-lres`, and trains a tiny sres
    run through its CLI on a synthetic dataset made here."""
    from long_video_gan_tpu.data.tools.synthetic import make_synthetic_dataset

    root = checkpoints[0]
    data = tmp_path / "data"
    make_synthetic_dataset(str(data), [(8, 16), (32, 64)], num_videos=3, frames_per_video=20,
                           num_partitions=1)
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'msgpack', 'long_video_gan_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import glob, os\n"
        "import torch\n"
        "import long_video_gan_tpu_torch\n"
        "import long_video_gan_tpu_torch.generate as g\n"
        "import long_video_gan_tpu_torch.selftest\n"
        "from long_video_gan_tpu_torch import train_sres\n"
        "from long_video_gan_tpu_torch.io.checkpoint import load_generator\n"
        "from long_video_gan_tpu_torch.ops import (filtered_lrelu_exact, filtered_lrelu_fused,\n"
        "                                          filtered_lrelu_polyphase)\n"
        f"lres, _ = load_generator({str(root / 'lres.lvg')!r})\n"
        f"sres, _ = load_generator({str(root / 'sres.lvg')!r})\n"
        "segs = list(g.generate_video(lres, sres, 4, segment_length=4,"
        " generator=torch.Generator().manual_seed(0), device=torch.device('cpu')))\n"
        "assert tuple(segs[0].shape) == (1, 3, 4, 32, 64)\n"
        f"out = {str(tmp_path / 'video.mp4')!r}\n"
        f"g.main(['--lres', {str(root / 'lres.lvg')!r}, '--sres', {str(root / 'sres.lvg')!r},"
        " '--output', out, '--frames', '4', '--segment-length', '4', '--save-lres',"
        " '--device', 'cpu'])\n"
        "assert os.path.exists(out) or os.path.isdir(out + '.frames')\n"
        f"run = train_sres.main(['--dataset', {str(data)!r}, '--preset', 'tiny', '--batch', '2',"
        f" '--outdir', {str(tmp_path / 'runs')!r}, '--total-steps', '2', '--device', 'cpu'])\n"
        "assert glob.glob(os.path.join(run, 'checkpoints', '*.lvg'))\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'msgpack',"
        " 'long_video_gan_tpu') and sys.modules[m] is not None]\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
