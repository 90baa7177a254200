"""`--remat` and `--block-remat` in the port (the counterpart of
tests/test_block_remat.py), on the CPU at the tiny presets, in f32:

- one training step of either trainer with `remat` (each G and D micro-batch
  loss recomputed in the backward), `block_remat` (each of G's blocks) or
  both, against the same step without: parameters, Adam states, the
  magnitude EMAs, w_avg, G_ema, ADA's p and the explicit generator's state
  within 1e-6 of each tensor's scale;
- the generators with `block_remat=True` against the JAX package's
  `block_remat=True` forward on carried-over weights, with the same module
  tree; their gradient and EMA updates equal the plain path's;
- both CLIs write the flags to `config.json` (`gan_kwargs.remat`,
  `gan_kwargs.G_kwargs.block_remat`) and the G_ema header, and resume with
  them.
"""

import json
import os
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from long_video_gan_tpu.models import generator_lres as jax_lres
from long_video_gan_tpu.models import generator_sres as jax_sres
from long_video_gan_tpu_torch import train_lres, train_sres
from long_video_gan_tpu_torch.data.tools.synthetic import make_synthetic_dataset
from long_video_gan_tpu_torch.io.checkpoint import load_generator
from long_video_gan_tpu_torch.io.convert_torch import load_jax_variables
from long_video_gan_tpu_torch.models import generator_lres, generator_sres
from test_torch_generators import ATOL, LRES_KW, RTOL, SRES_KW, random_variables
from test_torch_lres_train import one_torch_thread  # noqa: F401

FLAGS = {"remat": (True, False), "block_remat": (False, True), "both": (True, True)}
TRAINERS = {"sres": train_sres, "lres": train_lres}
STEP_TOL = 1e-6


def _batches(kind, c, seed):
    """An endless stream of the same seeded real batch of the tiny preset."""
    rng = np.random.default_rng(seed)
    n = c["total_batch"]
    if kind == "sres":
        t = c["seq_length"] + 2 * c["temporal_context"]
        batch = {"lr_video": rng.uniform(-1, 1, (n, 3, t, c["lr_height"], c["lr_width"])),
                 "hr_video": rng.uniform(-1, 1, (n, 3, t, c["hr_height"], c["hr_width"]))}
        batch = {k: torch.from_numpy(v.astype(np.float32)) for k, v in batch.items()}
    else:
        batch = torch.from_numpy(rng.uniform(
            -1, 1, (n, 3, c["seq_length"], c["height"], c["width"])).astype(np.float32))
    while True:
        yield batch


def _one_step(kind, remat, block_remat):
    """The trainer after step 0 (G, D, R1 and, for sres, ADA, then G_ema)
    from seeded weights and data, and the step's generator."""
    module = TRAINERS[kind]
    args = ("", 4, 2, 1.0, "tiny")
    c = (module.build_config(*args, remat=remat, block_remat=block_remat))
    assert c["gan_kwargs"]["remat"] == remat
    assert c["gan_kwargs"]["G_kwargs"]["block_remat"] == block_remat
    gan = module.make_gan(c, torch.device("cpu"))
    assert gan.remat == remat and gan.G.block_remat == block_remat
    gan.init_state(torch.Generator().manual_seed(7))
    generator = torch.Generator().manual_seed(8)
    stats = module.train_step(gan, generator, c, 0, _batches(kind, c, 9))
    return gan, generator, stats


def _state(gan):
    """Every tensor of the train state by name."""
    out = {}
    for name in ("G", "G_ema", "D"):
        out.update({f"{name}.{k}": v for k, v in getattr(gan, name).state_dict().items()})
    for name in ("opt_G", "opt_D"):
        opt = getattr(gan, name)
        out.update({f"{name}.mu.{i}": t for i, t in enumerate(opt.mu)})
        out.update({f"{name}.nu.{i}": t for i, t in enumerate(opt.nu)})
    if hasattr(gan, "ada_p"):
        out["ada_p"] = gan.ada_p
    return out


@pytest.fixture(scope="module")
def plain_steps():
    torch.set_num_threads(1)
    return {kind: _one_step(kind, False, False) for kind in TRAINERS}


@pytest.mark.parametrize("flag", list(FLAGS))
@pytest.mark.parametrize("kind", list(TRAINERS))
def test_step_with_recompute_matches_the_plain_step(kind, flag, plain_steps):
    """A step with the flag equals the plain one within STEP_TOL of each
    tensor's scale: the parameters, Adam's moments, the magnitude EMAs and
    w_avg (which the D phase moves, outside every recomputed region), G_ema,
    ADA's p; the explicit generator, rewound for each recompute, ends where
    the plain step left it; the statistics agree."""
    want_gan, want_gen, want_stats = plain_steps[kind]
    gan, gen, stats = _one_step(kind, *FLAGS[flag])
    assert torch.equal(gen.get_state(), want_gen.get_state())
    got, want = _state(gan), _state(want_gan)
    assert got.keys() == want.keys()
    emas = [k for k in want if "magnitude_ema" in k or "w_avg" in k]
    assert emas and any(not torch.equal(want[k], torch.ones_like(want[k])) for k in emas)
    for key, w in want.items():
        scale = max(w.abs().max().item(), 1e-30) if w.numel() else 1.0
        err = (got[key] - w).abs().max().item() if w.numel() else 0.0
        assert err <= STEP_TOL * scale, (key, err, scale)
    for phase, want_phase in zip(stats, want_stats):
        for name, value in want_phase.items():
            torch.testing.assert_close(phase[name], value, rtol=STEP_TOL, atol=0)


def test_sres_block_remat_matches_jax():
    """The sres G with block_remat=True against the JAX `nn.remat` one on the
    same carried-over weights, with EMA updates on: output and updated
    magnitude EMAs within the parity bars; the port's gradient and EMAs
    equal its plain path's."""
    kw = {**SRES_KW, "block_remat": True}
    G = jax_sres.VideoGenerator(**kw)
    variables = random_variables(G, jnp.zeros((1, 3, 8, 9, 16)), seed=20)
    rng = np.random.default_rng(21)
    lr = rng.standard_normal((2, 3, 8, 9, 16)).astype(np.float32)
    z = rng.standard_normal((2, 32)).astype(np.float32)
    want, new_vars = G.apply(variables, jnp.asarray(lr), z=jnp.asarray(z),
                             magnitude_ema_beta=0.9, mutable=["ema"])
    ports = {}
    for remat in (True, False):
        port = generator_sres.VideoGenerator(**{**SRES_KW, "block_remat": remat})
        load_jax_variables(port, variables)
        out = port(torch.from_numpy(lr), z=torch.from_numpy(z), magnitude_ema_beta=0.9)
        out.square().sum().backward()
        ports[remat] = port, out.detach()
    port, got = ports[True]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    _assert_emas_match(port, new_vars["ema"], 1 + len(port.SG3.synthesis.layers))
    _assert_same_module(ports[True][0], ports[False][0])


def test_lres_block_remat_matches_jax():
    """The lres G with block_remat=True against the JAX one (`nn.remat` per
    residual block) on the same weights and noise, EMA updates on: output
    and updated magnitude EMAs; its gradient and EMAs equal its plain
    path's."""
    kw = {**LRES_KW, "block_remat": True}
    G = jax_lres.VideoGenerator(**kw)
    variables = random_variables(G, 1, 8, seed=22)
    noise_shape = generator_lres.VideoGenerator(**LRES_KW).noise_shape(1, 8)
    noise = np.random.default_rng(23).standard_normal(noise_shape).astype(np.float32)
    want, new_vars = G.apply(variables, 1, 8, magnitude_ema_beta=0.9,
                             noise=jnp.asarray(noise), mutable=["ema"])
    ports = {}
    for remat in (True, False):
        port = generator_lres.VideoGenerator(**{**LRES_KW, "block_remat": remat})
        load_jax_variables(port, variables)
        out = port(1, 8, magnitude_ema_beta=0.9, noise=torch.from_numpy(noise))
        out.square().sum().backward()
        ports[remat] = port, out.detach()
    port, got = ports[True]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    _assert_emas_match(port, new_vars["ema"], 2 * 10 + 1)
    _assert_same_module(ports[True][0], ports[False][0])


def _assert_emas_match(port, ema_tree, count):
    """The port's updated EMA buffers (magnitude EMAs, w_avg) against the JAX
    "ema" collection, by name, at the parity bars."""
    want = {re.sub(r"_layers_(\d+)", r"_layers.\1", ".".join(str(k.key) for k in path)): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(ema_tree)[0]}
    state = port.state_dict()
    assert len(want) == count and want.keys() <= state.keys(), sorted(want)[:4]
    for key, leaf in want.items():
        np.testing.assert_allclose(state[key].numpy(), np.asarray(leaf), rtol=RTOL, atol=ATOL,
                                   err_msg=key)


def _assert_same_module(remat, plain):
    """The same state-dict keys; equal buffers (the EMAs moved once) and
    gradients within 1e-6 of each one's scale."""
    assert remat.state_dict().keys() == plain.state_dict().keys()
    for (name, a), b in zip(remat.state_dict().items(), plain.state_dict().values()):
        assert torch.equal(a, b), name
    for (name, a), b in zip(remat.named_parameters(), plain.parameters()):
        if b.grad is None:
            assert a.grad is None, name
            continue
        scale = max(b.grad.abs().max().item(), 1e-30)
        assert (a.grad - b.grad).abs().max().item() <= 1e-6 * scale, name


@pytest.mark.parametrize("kind", list(TRAINERS))
def test_cli_records_and_resumes_with_both_flags(kind, tmp_path, one_torch_thread):  # noqa: F811
    """Each CLI with --remat --block-remat trains the tiny preset, writes both
    flags to config.json and the G_ema header (whose generator loads with
    them), and resumes from its train checkpoint with them."""
    make_synthetic_dataset(str(tmp_path / "data"), [(8, 16), (32, 64)], num_videos=2,
                           frames_per_video=20, num_partitions=1)
    module = TRAINERS[kind]
    common = ["--dataset", str(tmp_path / "data"), "--preset", "tiny", "--batch", "4",
              "--outdir", str(tmp_path / "runs"), "--seed", "1", "--device", "cpu",
              "--remat", "--block-remat"]
    run_dir = module.main(common + ["--total-steps", "2"])
    config = json.load(open(os.path.join(run_dir, "config.json")))
    assert config["gan_kwargs"]["remat"] is True
    assert config["gan_kwargs"]["G_kwargs"]["block_remat"] is True
    ckpts = os.path.join(run_dir, "checkpoints")
    G, header = load_generator(os.path.join(ckpts, "ckpt-00000002-G-ema.lvg"))
    assert header["kwargs"]["block_remat"] is True and G.block_remat is True
    resumed = module.main(common + ["--resume", os.path.join(ckpts, "ckpt-00000000-train.lvg"),
                                    "--total-steps", "2"])
    config = json.load(open(os.path.join(resumed, "config.json")))
    assert config["gan_kwargs"]["remat"] and config["gan_kwargs"]["G_kwargs"]["block_remat"]
    records = [json.loads(line) for line in open(os.path.join(resumed, "stats.jsonl"))]
    assert records and all(np.isfinite(r["loss/G_loss"]) for r in records)
