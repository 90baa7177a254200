"""Train checkpoints across the frameworks, and resume, for both trainers, on
the CPU: a train checkpoint that the JAX package's `save_checkpoint` writes
loads into the port with every tensor equal; the port's own loads in the JAX
package with `load_checkpoint(target=state)` and gives back the same tree;
and a run resumed at step k, fed the same batches, reaches bit for bit the
state at step k + 1 of the run that went on."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from long_video_gan_tpu.io import checkpoint as jax_checkpoint
from long_video_gan_tpu.train.gan_lres import LowResVideoGAN as JaxLowResVideoGAN
from long_video_gan_tpu.train.gan_sres import SuperResVideoGAN as JaxSuperResVideoGAN
from long_video_gan_tpu_torch import train_lres, train_sres
from long_video_gan_tpu_torch.io.convert_torch import flatten_variables
from long_video_gan_tpu_torch.train.common import step_generator
from long_video_gan_tpu_torch.train.gan_lres import LowResVideoGAN
from long_video_gan_tpu_torch.train.gan_sres import SuperResVideoGAN
from long_video_gan_tpu_torch.train.state import load_train_checkpoint, save_train_checkpoint
from test_torch_lres_train import LRES_CFG, one_torch_thread  # noqa: F401
from test_torch_train import SRES_CFG

TRAINERS = {"lres": (JaxLowResVideoGAN, LowResVideoGAN, LRES_CFG),
            "sres": (JaxSuperResVideoGAN, SuperResVideoGAN, SRES_CFG)}


def _jax_state(kind, seed):
    """A JAX `GANState` of the trainer's shapes (`jax.eval_shape` of its
    `init_state`, no init trace) filled from a seeded numpy generator: every
    float leaf random, the step and optimizer counts nonzero; as in every
    state optax makes, each optimizer's two counts agree and eps_root is 0."""
    gan_j = TRAINERS[kind][0](**TRAINERS[kind][2])
    shapes = jax.eval_shape(gan_j.init_state, jax.random.key(0))
    rng = np.random.default_rng(seed)

    def fill(s):
        if jnp.issubdtype(s.dtype, jnp.integer):
            return np.full(s.shape, rng.integers(1, 100), s.dtype)
        return rng.standard_normal(s.shape).astype(s.dtype)

    state = jax.tree.map(fill, shapes)
    opts = {}
    for name in ("opt_G", "opt_D"):
        opt = getattr(state, name)
        opts[name] = opt._replace(count=opt.inner_state[0].count,
                                  hyperparams=dict(opt.hyperparams,
                                                   eps_root=np.zeros((), np.float32)))
    return state.replace(**opts)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("kind", sorted(TRAINERS))
def test_jax_train_checkpoint_resumes_in_port_and_back(kind, tmp_path):
    state = _jax_state(kind, seed=70)
    jax_checkpoint.save_checkpoint(str(tmp_path / "jax.lvg"), state, dict(step=int(state.step)))
    gan = TRAINERS[kind][1](**TRAINERS[kind][2], device="cpu")
    header = load_train_checkpoint(str(tmp_path / "jax.lvg"), gan)
    assert gan.step == header["step"] == int(state.step)
    for name in ("G", "G_ema", "D"):
        arrays = flatten_variables(getattr(state, name))
        module_state = getattr(gan, name).state_dict()
        assert set(arrays) == set(module_state)
        for key, value in module_state.items():
            np.testing.assert_array_equal(value.numpy(), arrays[key])
    for opt, module, opt_state in ((gan.opt_G, gan.G, state.opt_G),
                                   (gan.opt_D, gan.D, state.opt_D)):
        assert opt.count == int(opt_state.count) == int(opt_state.inner_state[0].count)
        assert opt.lrate == float(opt_state.hyperparams["learning_rate"])
        names = [n for n, _ in module.named_parameters()]
        for which, tensors in (("mu", opt.mu), ("nu", opt.nu)):
            arrays = flatten_variables({which: getattr(opt_state.inner_state[0], which)})
            for name, tensor in zip(names, tensors):
                np.testing.assert_array_equal(tensor.numpy(), arrays[name])
    if kind == "sres":
        np.testing.assert_array_equal(gan.ada_p.numpy(), np.asarray(state.ada_p))
        np.testing.assert_array_equal(gan.sign_real_moments.numpy(),
                                      np.asarray(state.sign_real_moments))

    # The port's checkpoint of that state loads in the JAX package as its own.
    save_train_checkpoint(str(tmp_path / "port.lvg"), gan)
    target = _jax_state(kind, seed=71)
    back, config = jax_checkpoint.load_checkpoint(str(tmp_path / "port.lvg"), target=target)
    assert config == {"step": int(state.step)}
    want, got = _leaves(state), _leaves(back)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _lres_batches(n, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.uniform(-1, 1, (8, 3, 8, 18, 32)).astype(np.float32))
            for _ in range(n)]


def _sres_batches(n, seed):
    rng = np.random.default_rng(seed)
    return [{"lr_video": torch.from_numpy(rng.uniform(-1, 1, (8, 3, 6, 9, 16))
                                          .astype(np.float32)),
             "hr_video": torch.from_numpy(rng.uniform(-1, 1, (8, 3, 6, 36, 64))
                                          .astype(np.float32))} for _ in range(n)]


@pytest.mark.parametrize("kind", sorted(TRAINERS))
def test_resumed_run_continues_bit_for_bit(kind, tmp_path):
    """Steps 0-2 in one run, against steps 0-1, a train checkpoint, and step
    2 (which runs R1, and ADA for sres) in a new trainer loaded from it."""
    cli = train_lres if kind == "lres" else train_sres
    c = dict(r1_interval=2, ada_interval=2)
    make = TRAINERS[kind][1]
    cfg = dict(TRAINERS[kind][2], G_grad_accum=2, D_grad_accum=2)
    batches = (_lres_batches if kind == "lres" else _sres_batches)(6, seed=72)
    per_step = {0: batches[:3], 1: batches[3:5], 2: batches[5:] + batches[:2]}

    def run_step(gan, step):
        cli.train_step(gan, step_generator(5, step, "cpu"), c, step, iter(per_step[step]))

    gan = make(**cfg, device="cpu")
    gan.init_state(torch.Generator().manual_seed(0))
    run_step(gan, 0)
    run_step(gan, 1)
    save_train_checkpoint(str(tmp_path / "train.lvg"), gan)
    run_step(gan, 2)

    resumed = make(**cfg, device="cpu")
    resumed.init_state(torch.Generator().manual_seed(1))
    load_train_checkpoint(str(tmp_path / "train.lvg"), resumed)
    assert resumed.step == 2
    run_step(resumed, 2)
    assert resumed.step == gan.step == 3
    for name in ("G", "G_ema", "D"):
        want, got = getattr(gan, name).state_dict(), getattr(resumed, name).state_dict()
        for key in want:
            assert torch.equal(got[key], want[key]), (name, key)
    for a, b in ((gan.opt_G, resumed.opt_G), (gan.opt_D, resumed.opt_D)):
        assert a.count == b.count and a.lrate == b.lrate
        assert all(torch.equal(x, y) for x, y in zip(a.nu + a.mu, b.nu + b.mu))
    if kind == "sres":
        assert torch.equal(gan.ada_p, resumed.ada_p)
