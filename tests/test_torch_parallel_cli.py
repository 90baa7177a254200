"""The lres trainer CLI on two processes over gloo on the CPU, at the `tiny`
preset and a global batch of 4 on a synthetic dataset
(tests/test_torch_parallel_sres_cli.py runs the same tests on the sres CLI):

- exactly one run directory is made, and only rank 0 writes into it (one
  config.json, one stats.jsonl line per tick, one set of checkpoints and
  samples);
- the G_ema checkpoint of the first tick (step 2) equals a one-process
  run's at the same global batch within 1e-5 of the largest value of each
  part of it (the parameters; the magnitude EMAs and w_avg);
- the train checkpoint after 4 steps does too, in the relative L2 norm of
  each part (each module's parameters and buffers, ada_p and ADA's sign
  moments), and the optimizer's moments within 1e-3. One rank and two sum
  in another order; a GAN step amplifies such float32 differences: a 1e-7
  relative perturbation of one process's own G and D weights moves G's
  gradients at step 2 (the third) by up to 1.2e-4 of their largest value,
  as two ranks do (9e-5 there), while after two steps every part still
  agrees within 1.1e-6. tests/test_torch_parallel.py holds the whole state
  of one step to 1e-5 of each tensor;
- `--resume` on two ranks from the step-0 train checkpoint continues the
  run: its G_ema at step 2 equals the uninterrupted two-rank run's bit for
  bit;
- several processes without `--seed` refuse to start.

The processes import torch and the port, never jax (the CLIs' own modules).
"""

import contextlib
import importlib
import json
import os

import numpy as np
import pytest
import torch

from long_video_gan_tpu_torch.data.tools.synthetic import make_synthetic_dataset
from long_video_gan_tpu_torch.io.checkpoint import load_checkpoint
from test_torch_parallel import RTOL, WORLD, assert_close, spawn

STEPS = 4


@contextlib.contextmanager
def one_torch_thread():
    """One intra-op thread, as each spawned process has."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _cli(kind: str, data: str, outdir: str, *extra: str, steps: int = STEPS) -> list[str]:
    return ["-m", f"long_video_gan_tpu_torch.train_{kind}", "--dataset", data, "--preset",
            "tiny", "--batch", "4", "--outdir", outdir, "--seed", "1", "--device", "cpu",
            "--total-steps", str(steps), *extra]


def _part(path: tuple) -> tuple:
    """The part of a checkpoint an array belongs to: a module's parameters
    or its buffers ("ema": magnitude EMAs, w_avg), an optimizer's mu or nu,
    else the array itself."""
    if path[0].startswith("opt_"):
        return next(((path[0], m) for m in ("mu", "nu") if m in path), path)
    if path[0] in ("G", "G_ema", "D"):
        return path[:2]
    return path[:1] if path[0] in ("params", "ema") else path


def _parts(path: str) -> dict:
    """{part: (the arrays' values, flattened, float64)} of a checkpoint."""
    tree, header = load_checkpoint(path)
    parts = {}
    for p, value in _leaves(tree):
        parts.setdefault(_part(p), []).append(np.asarray(value, np.float64).ravel())
    return {k: np.concatenate(v) for k, v in parts.items()}, header


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, path + (str(key),))
    else:
        yield path, np.asarray(tree)


KIND = "lres"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return make_runs(KIND, tmp_path_factory)


def make_runs(kind: str, tmp_path_factory):
    """Two ranks, one process and two ranks resumed from step 0."""
    root = tmp_path_factory.mktemp(f"parallel_{kind}")
    data = str(root / "data")
    make_synthetic_dataset(data, [(8, 16), (32, 64)], num_videos=5, frames_per_video=20,
                           num_partitions=1)
    outs = spawn(_cli(kind, data, str(root / "two")))
    main = importlib.import_module(f"long_video_gan_tpu_torch.train_{kind}").main
    with one_torch_thread():
        main(_cli(kind, data, str(root / "one"))[2:])
    (two_dir,) = [str(root / "two" / d) for d in os.listdir(root / "two")]
    ckpt0 = os.path.join(two_dir, "checkpoints", "ckpt-00000000-train.lvg")
    spawn(_cli(kind, data, str(root / "resumed"), "--resume", ckpt0, steps=2))
    return kind, root, outs


def _run_dir(root, name):
    dirs = os.listdir(root / name)
    assert len(dirs) == 1, dirs
    return root / name / dirs[0]


def test_one_run_dir_and_only_rank0_writes(runs):
    kind, root, outs = runs
    run_dir = _run_dir(root, "two")
    config = json.load(open(run_dir / "config.json"))
    assert config["processes"] == WORLD and config["seed"] == 1
    records = [json.loads(line) for line in open(run_dir / "stats.jsonl")]
    assert [r["step"] for r in records] == [2, 4]
    ckpts = sorted(os.listdir(run_dir / "checkpoints"))
    assert ckpts == sorted([f"ckpt-{s:08d}-G-ema.lvg" for s in (0, 2, 4)]
                           + [f"ckpt-{s:08d}-train.lvg" for s in (0, 4)])
    assert sorted(os.listdir(run_dir / "samples")) == sorted(os.listdir(_run_dir(root, "one")
                                                                     / "samples"))
    assert "Run dir:" in outs[0] and "Wrote the checkpoints" in outs[0]
    assert "Run dir:" not in outs[1] and "Wrote the checkpoints" not in outs[1]


def _both(root, name: str):
    two, header_two = _parts(str(_run_dir(root, "two") / "checkpoints" / name))
    one, header_one = _parts(str(_run_dir(root, "one") / "checkpoints" / name))
    assert header_two.get("step") == header_one.get("step") and two.keys() == one.keys()
    return two, one


def test_g_ema_checkpoint_matches_one_process(runs):
    kind, root, _ = runs
    two, one = _both(root, "ckpt-00000002-G-ema.lvg")
    assert {("params",), ("ema",)} <= one.keys()
    for part, want in one.items():
        assert_close(torch.from_numpy(two[part]), torch.from_numpy(want), "/".join(part))


def test_train_checkpoint_matches_one_process(runs):
    kind, root, _ = runs
    two, one = _both(root, f"ckpt-{STEPS:08d}-train.lvg")
    assert {("G", "params"), ("D", "params"), ("opt_G", "mu"), ("opt_D", "nu")} <= one.keys()
    for part, want in one.items():
        got, name = two[part], "/".join(part)
        if part[0].startswith("opt_") and part[1] in ("mu", "nu"):
            assert_close(torch.from_numpy(got), torch.from_numpy(want), name, rtol=1e-3)
        else:
            rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
            assert rel <= RTOL, f"{name}: relative L2 difference {rel:.3e}"


def test_resume_on_two_ranks_continues(runs):
    kind, root, _ = runs
    resumed = _run_dir(root, "resumed")
    records = [json.loads(line) for line in open(resumed / "stats.jsonl")]
    assert [r["step"] for r in records] == [2]
    name = "ckpt-00000002-G-ema.lvg"
    got, _ = load_checkpoint(str(resumed / "checkpoints" / name))
    want, _ = load_checkpoint(str(_run_dir(root, "two") / "checkpoints" / name))
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for path, value in want.items():
        np.testing.assert_array_equal(got[path], value, err_msg="/".join(path))


def test_several_processes_need_a_seed(runs, tmp_path):
    kind, root, _ = runs
    argv = _cli(kind, str(tmp_path / "no-data"), str(tmp_path / "runs"))
    argv = argv[:argv.index("--seed")] + argv[argv.index("--seed") + 2:]
    outs = spawn(argv, check=False)
    assert all("multi-host runs must pass --seed" in out for out in outs)
    assert not os.path.exists(tmp_path / "runs")
