"""The port's parallel layer on the CPU: several processes over gloo.

The multi-process cases start this file as a script, one process per rank,
on a free localhost port (as tests/test_multihost.py does for the JAX
package); the processes import torch and the port, never jax. Each writes
its results to a file, and the test holds them to the same function run in
one process without a process group:

- the launch variables (torchrun's and the JAX package's `LVG_*`), the no-op
  without them, the TPU-pod `auto` error and `local_batch_size`'s assertion;
- the collectives, the global draws and the gathered batch with its first
  and second gradients;
- one `train_step` of each tiny trainer on 2 ranks against 1 rank at the
  same global batch, with DiffAugment, the temporal augmentations, ADA at
  p > 0 with its update, grad-accum 2 and an R1 step: the ranks bit-equal
  to each other and within 1e-5 of one rank in the parameters, G_ema, the
  Adam moments, the magnitude EMAs, w_avg, ada_p and the stats record;
- the sres D's minibatch-std layer, whose groups span the processes, with
  its first gradient and R1's second one, in float64.

Each tensor is held to 1e-5 of its largest value, the parameters and G_ema
to 1e-5 of their module's largest (`parallel.selfcheck` says why). The
trainer step runs the sres D as released, without the minibatch-std layer:
R1 differentiates through the square root of a group's variance, and there
one rank's own R1 gradients move 2-4e-5 of their tensors' largest when the
inputs move 1e-7; the layer is held in float64 instead.
"""

from __future__ import annotations

import copy
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from long_video_gan_tpu_torch.parallel import mesh, multihost, selfcheck  # noqa: E402

RTOL = 1e-5
WORLD = 2
SEED = 3


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(argv: list[str], world: int = WORLD, timeout: float = 300,
          launcher: str = "torchrun", check: bool = True) -> list[str]:
    """Run `python argv...` as `world` processes of one gloo group on
    localhost (`launcher` None: as one process without the launch
    variables); returns their outputs and, with `check`, raises if any
    failed."""
    port = free_port()
    procs = []
    for r in range(world):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("LVG_", "MASTER_")) and k not in ("RANK", "WORLD_SIZE",
                                                                     "LOCAL_RANK")}
        if launcher == "torchrun":
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(r),
                       WORLD_SIZE=str(world), LOCAL_RANK=str(r))
        elif launcher == "lvg":
            env.update(LVG_COORDINATOR=f"127.0.0.1:{port}", LVG_NUM_PROCESSES=str(world),
                       LVG_PROCESS_ID=str(r))
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        env["OMP_NUM_THREADS"] = "1"     # one intra-op thread per process
        procs.append(subprocess.Popen([sys.executable, *argv], env=env, cwd=REPO,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 or not check, f"rank {r} failed:\n{out[-4000:]}"
    return outs


def assert_close(got: torch.Tensor, want: torch.Tensor, name: str, rtol: float = RTOL,
                 scale: float | None = None):
    """max |got - want| <= rtol * `scale` (want's largest |value| unless given)."""
    got, want = got.double(), want.double()
    scale = want.abs().max().item() if scale is None else scale
    err = (got - want).abs().max().item()
    assert err <= rtol * max(scale, 1e-30), f"{name}: max |diff| {err:.3e} of {scale:.3e}"


# ---------------------------------------------------------------------------
# One training step of each tiny trainer, the same function on 1 and 2 ranks
# (`parallel.selfcheck`, which chip_smoke.py runs on the card too).


@pytest.fixture(scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=["lres", "sres"])
def step_results(request, tmp_path_factory, one_thread):
    kind = request.param
    out = tmp_path_factory.mktemp(f"step_{kind}")
    spawn([__file__, "train", kind, str(out)])
    ranks = [torch.load(out / f"rank{r}.pt") for r in range(WORLD)]
    return kind, ranks, selfcheck.tiny_step(kind)


def test_step_ranks_are_bit_equal(step_results):
    _, ranks, _ = step_results
    assert ranks[0].keys() == ranks[1].keys()
    for key, value in ranks[0].items():
        assert torch.equal(value, ranks[1][key]), key


def test_step_on_two_ranks_matches_one(step_results):
    kind, ranks, one = step_results
    state = {k: v for k, v in one.items() if not k.startswith("stats.")}
    got = {k: ranks[0][k] for k in state}
    errors = selfcheck.relative_errors(got, state, selfcheck.param_keys(
        selfcheck.trainer(kind, "cpu")[2]))
    worst = max(errors, key=errors.get)
    assert errors[worst] <= RTOL, f"{worst}: {errors[worst]:.3e}"
    # Every kind of state the step moves, moved alike.
    names = " ".join(state)
    assert "magnitude_ema" in names and "opt_D.nu" in names
    if kind == "sres":
        assert "w_avg" in names
        assert one["ada_p"].item() != 0.5


def test_step_stats_record_on_two_ranks_matches_one(step_results):
    kind, ranks, one = step_results
    stats = sorted(k for k in one if k.startswith("stats."))
    assert stats == sorted(k for k in ranks[0] if k.startswith("stats."))
    assert "stats.loss/r1_penalty" in stats
    if kind == "sres":
        assert "stats.progress/augment_p" in stats
    for key in stats:
        assert_close(ranks[0][key], one[key], key)


def _train_worker(kind: str, out: str) -> None:
    torch.save(selfcheck.tiny_step(kind), os.path.join(out, f"rank{multihost.rank()}.pt"))


# ---------------------------------------------------------------------------
# The collectives, draws and gathered batch on 2 ranks.


def _collectives_worker(out: str) -> None:
    r, w = multihost.rank(), multihost.world_size()
    result = {}
    a = [torch.full((3,), float(r + 1)), torch.arange(4.0).reshape(2, 2) * (r + 1)]
    mesh.all_reduce_sum_(a)
    result["sum"] = torch.cat([t.flatten() for t in a])
    b = [torch.full((2,), float(r + 1))]
    mesh.all_reduce_mean_(b)
    result["mean"] = b[0]
    module = torch.nn.Linear(3, 2)
    torch.nn.init.constant_(module.weight, float(r))
    extra = torch.full((2,), float(r + 5))
    mesh.replicate(module, [extra])
    result["replicated"] = torch.cat([module.weight.detach().flatten(), extra])
    result["object"] = torch.tensor(mesh.broadcast_object(r + 10))
    gen = torch.Generator().manual_seed(7)
    result["draw"] = mesh.global_draw(lambda m: torch.rand((m, 2), generator=gen), 3)
    # The gathered batch: rows of rank r are x_r = (r + 1) * base.
    base = torch.arange(6.0).reshape(3, 2).requires_grad_(True)
    x = base * (r + 1)
    g = mesh.all_gather_batch(x)
    result["gathered"] = g.detach()
    weights = torch.arange(g.numel(), dtype=torch.float32).reshape(g.shape) + 10 * r
    loss = (mesh.local_rows(g.square() * weights)).sum()
    (grad,) = torch.autograd.grad(loss, base, create_graph=True)
    result["grad"] = grad.detach()
    (grad2,) = torch.autograd.grad(grad.square().sum(), base)
    result["grad2"] = grad2
    torch.save(result, os.path.join(out, f"rank{r}.pt"))
    assert w == WORLD


def test_collectives_on_two_ranks(tmp_path, one_thread):
    spawn([__file__, "collectives", str(tmp_path)])
    res = [torch.load(tmp_path / f"rank{r}.pt") for r in range(WORLD)]
    for r in range(WORLD):
        torch.testing.assert_close(res[r]["sum"], torch.cat([torch.full((3,), 3.0),
                                                             torch.arange(4.0) * 3]))
        torch.testing.assert_close(res[r]["mean"], torch.full((2,), 1.5))
        torch.testing.assert_close(res[r]["replicated"], torch.tensor([0.0] * 6 + [5.0, 5.0]))
        assert res[r]["object"].item() == 10
        full = torch.rand((3 * WORLD, 2), generator=torch.Generator().manual_seed(7))
        torch.testing.assert_close(res[r]["draw"], full[r::WORLD])
    # Global row 2 j + r is row j of rank r.
    base = torch.arange(6.0).reshape(3, 2)
    want = torch.stack([base * (r + 1) for r in range(WORLD)], dim=1).reshape(6, 2)
    for r in range(WORLD):
        torch.testing.assert_close(res[r]["gathered"], want)
    # The first and second gradients of the sum of the ranks' losses, each
    # rank's with respect to its own rows.
    xs = [(base * (r + 1)).requires_grad_(True) for r in range(WORLD)]
    total = 0
    for r in range(WORLD):
        g = torch.stack(xs, dim=1).reshape(6, 2)
        weights = torch.arange(12, dtype=torch.float32).reshape(6, 2) + 10 * r
        total = total + (g.square() * weights)[r::WORLD].sum()
    grads = torch.autograd.grad(total, xs, create_graph=True)
    for r in range(WORLD):
        torch.testing.assert_close(res[r]["grad"], grads[r] * (r + 1))
    second = torch.autograd.grad(sum((g * (r + 1)).square().sum() for r, g in enumerate(grads)),
                                 xs)
    for r in range(WORLD):
        torch.testing.assert_close(res[r]["grad2"], second[r] * (r + 1))


def mbstd_grads() -> dict:
    """A D head around `MinibatchStdLayer` (group 4, 1 channel) in float64
    on this process's rows of a global batch of 8: its output, the
    parameter gradients of the mean softplus loss and of an R1 penalty (the
    squared input gradient of the summed logits), averaged over the
    processes as the trainers average them."""
    from long_video_gan_tpu_torch.models.discriminator_sres import MinibatchStdLayer

    rng = np.random.default_rng(SEED + 2)
    x = mesh.local_rows(torch.from_numpy(rng.standard_normal((8, 4, 3, 3))))
    w1 = torch.from_numpy(rng.standard_normal((4, 1, 1))).requires_grad_(True)
    w2 = torch.from_numpy(rng.standard_normal((5, 3, 3))).requires_grad_(True)
    layer = MinibatchStdLayer(4, 1)

    def logits(v):
        return (layer(torch.tanh(v * w1)) * w2).sum(dim=(1, 2, 3))

    out = {"y": layer(x * w1).detach()}
    loss = torch.nn.functional.softplus(logits(x)).mean()
    out["grad_w1"], out["grad_w2"] = torch.autograd.grad(loss, [w1, w2])
    xr = x.clone().requires_grad_(True)
    (gx,) = torch.autograd.grad(logits(xr).sum(), xr, create_graph=True)
    out["r1_grad_x"] = gx.detach()
    penalty = gx.square().sum(dim=(1, 2, 3)).mean()
    out["r1_grad_w1"], out["r1_grad_w2"] = torch.autograd.grad(penalty, [w1, w2])
    mesh.all_reduce_mean_([out[k] for k in ("grad_w1", "grad_w2", "r1_grad_w1", "r1_grad_w2")])
    return out


def _mbstd_worker(out: str) -> None:
    torch.save(mbstd_grads(), os.path.join(out, f"rank{multihost.rank()}.pt"))


def test_minibatch_std_on_two_ranks_matches_one(tmp_path, one_thread):
    """Groups over the global batch: the layer's output, its first-order
    gradients and the R1 penalty's (through the gathered batch twice) on 2
    ranks equal one process's in float64."""
    spawn([__file__, "mbstd", str(tmp_path)])
    one = mbstd_grads()
    for r in range(WORLD):
        got = torch.load(tmp_path / f"rank{r}.pt")
        for key in ("y", "r1_grad_x"):
            torch.testing.assert_close(got[key], one[key][r::WORLD], rtol=1e-12, atol=1e-12)
        for key in ("grad_w1", "grad_w2", "r1_grad_w1", "r1_grad_w2"):
            torch.testing.assert_close(got[key], one[key], rtol=1e-12, atol=1e-12)


def test_lvg_variables_form_the_same_group(tmp_path, one_thread):
    """The JAX package's launch variables start the same two-rank group."""
    outs = spawn([__file__, "whoami", str(tmp_path)], launcher="lvg")
    assert sorted(o.strip().splitlines()[-1] for o in outs) == ["rank 0 of 2", "rank 1 of 2"]


# ---------------------------------------------------------------------------
# The launch variables, in this process (no group is formed).


@pytest.fixture
def clean_env(monkeypatch):
    for key in list(os.environ):
        if key.startswith(("LVG_", "MASTER_")) or key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
            monkeypatch.delenv(key)
    return monkeypatch


def test_torchrun_variables(clean_env):
    clean_env.setenv("RANK", "3")
    clean_env.setenv("WORLD_SIZE", "8")
    clean_env.setenv("LOCAL_RANK", "1")
    clean_env.setenv("MASTER_ADDR", "node0")
    clean_env.setenv("MASTER_PORT", "1234")
    clean_env.setenv("LVG_COORDINATOR", "ignored:1")
    assert multihost._launch_from_env() == dict(init_method="tcp://node0:1234", rank=3,
                                                world_size=8, local_rank=1)


def test_lvg_variables(clean_env):
    clean_env.setenv("LVG_COORDINATOR", "host0:4321")
    clean_env.setenv("LVG_NUM_PROCESSES", "4")
    clean_env.setenv("LVG_PROCESS_ID", "2")
    clean_env.setenv("LVG_LOCAL_DEVICE_IDS", "5")
    assert multihost._launch_from_env() == dict(init_method="tcp://host0:4321", rank=2,
                                                world_size=4, local_rank=5)
    clean_env.setenv("LVG_LOCAL_DEVICE_IDS", "0,1")
    with pytest.raises(ValueError, match="one id"):
        multihost._launch_from_env()
    clean_env.delenv("LVG_LOCAL_DEVICE_IDS")
    clean_env.setenv("LOCAL_RANK", "1")
    assert multihost._launch_from_env()["local_rank"] == 1


def test_lvg_auto_raises(clean_env):
    clean_env.setenv("LVG_COORDINATOR", "auto")
    with pytest.raises(RuntimeError, match="TPU-pod"):
        multihost.maybe_initialize_distributed("cpu")


def test_without_variables_one_process_and_noop_helpers(clean_env):
    assert multihost.maybe_initialize_distributed("cpu") is False
    assert (multihost.rank(), multihost.world_size(), multihost.is_main_process()) == (0, 1, True)
    assert multihost.local_batch_size(8) == 8
    assert multihost.local_device("cuda") == torch.device("cuda")
    assert not mesh.distributed()
    assert mesh.shard_batch(8) == dict(batch_size=8, shard_id=0, num_shards=1)
    x = [torch.arange(3.0)]
    assert mesh.all_reduce_mean_(x) is x and torch.equal(x[0], torch.arange(3.0))
    assert mesh.all_reduce_sum_(x) is x and torch.equal(x[0], torch.arange(3.0))
    y = torch.arange(4.0).reshape(2, 2)
    assert mesh.all_gather_batch(y) is y and mesh.local_rows(y) is y
    assert mesh.mean_over_processes(y) is y
    gen = torch.Generator().manual_seed(1)
    draw = mesh.global_draw(lambda m: torch.rand((m,), generator=gen), 5)
    assert torch.equal(draw, torch.rand((5,), generator=torch.Generator().manual_seed(1)))
    assert mesh.broadcast_object("a") == "a"
    mesh.replicate(torch.nn.Linear(2, 2))
    mesh.barrier()


def test_local_batch_size_assertion(monkeypatch):
    monkeypatch.setattr(multihost, "world_size", lambda: 3)
    assert multihost.local_batch_size(9) == 3
    with pytest.raises(AssertionError, match="total batch 8 not divisible by 3 hosts"):
        multihost.local_batch_size(8)


# ---------------------------------------------------------------------------
# The loader's shards.


@pytest.mark.parametrize("num_videos", [7, 2])
def test_loader_shards_read_one_process_batches(tmp_path, num_videos):
    """2 shards at batch 2 read, sample for sample, the batches 1 process
    reads at batch 4: global row q is row q // 2 of shard q % 2. 7 clips cut
    each epoch to whole global batches; 2 are fewer than one."""
    from long_video_gan_tpu_torch.data.dataset import VideoDataset
    from long_video_gan_tpu_torch.data.loader import get_infinite_data_iter
    from long_video_gan_tpu_torch.data.tools.synthetic import make_synthetic_dataset

    make_synthetic_dataset(str(tmp_path / "data"), [(8, 16)], num_videos=num_videos,
                           frames_per_video=12, num_partitions=1)
    ds = VideoDataset(str(tmp_path / "data"), 4, 8, 16, x_flip=True)
    kw = dict(seed=5, num_workers=2, prefetch=2)
    one = get_infinite_data_iter(ds, batch_size=4, **kw)
    shards = [get_infinite_data_iter(ds, batch_size=2, shard_id=s, num_shards=2, **kw)
              for s in range(2)]
    try:
        for _ in range(5):
            want = next(one)["video"]
            parts = [next(s)["video"] for s in shards]
            np.testing.assert_array_equal(np.stack(parts, axis=1).reshape(want.shape), want)
    finally:
        for loader in [one, *shards]:
            loader.close()


# ---------------------------------------------------------------------------
# Script mode: one rank of a multi-process case.


TEMPORAL_G = dict(out_height=8, out_width=16, temporal_emb_dim=64, latent_w_dim=64,
                  temporal_padding=2, channel_max=16,
                  embedding_kwargs=dict(min_sampling_rate=10, max_sampling_rate=40,
                                        blur_widths=16))


def temporal_G():
    """tests/test_temporal_sharding.py's tiny lres G, weights from SEED."""
    from long_video_gan_tpu_torch.models.common import init_weights_
    from long_video_gan_tpu_torch.models.generator_lres import VideoGenerator

    return init_weights_(VideoGenerator(**TEMPORAL_G), torch.Generator().manual_seed(SEED))


def temporal_models() -> dict:
    """`temporal_G` as it is and as a float64 copy: {"float32": G, "float64": G64}."""
    G = temporal_G()
    return {"float32": G, "float64": copy.deepcopy(G).double()}


def _temporal_worker(out: str) -> None:
    """The video of shard length total_temporal_scale per rank, from the
    noise of generator seed 7, at the default halo, by each of
    `temporal_models`."""
    from long_video_gan_tpu_torch.parallel.temporal import synthesize_time_sharded

    videos = {}
    for name, G in temporal_models().items():
        seq_length = G.total_temporal_scale * multihost.world_size()
        with torch.no_grad():
            videos[name] = synthesize_time_sharded(G, 1, seq_length,
                                                   torch.Generator().manual_seed(7))
    torch.save(videos, os.path.join(out, f"rank{multihost.rank()}.pt"))


def _whoami_worker(out: str) -> None:
    print(f"rank {multihost.rank()} of {multihost.world_size()}")


if __name__ == "__main__":
    torch.set_num_threads(1)
    assert multihost.maybe_initialize_distributed("cpu"), "no launch variables"
    mode, *rest = sys.argv[1:]
    {"train": _train_worker, "collectives": _collectives_worker, "mbstd": _mbstd_worker,
     "temporal": _temporal_worker, "whoami": _whoami_worker}[mode](*rest)
    torch.distributed.destroy_process_group()
    assert not any(m.split(".")[0] in ("jax", "flax", "long_video_gan_tpu") for m in sys.modules)
