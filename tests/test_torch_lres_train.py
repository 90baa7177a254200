"""The port's lres trainer against the JAX package's, on the CPU, at
tests/test_train_steps.py's tiny LRES_CFG.

One micro-batch of each phase (G loss; D loss after the D phase's generator
pass, which moves the magnitude EMAs; R1 penalty) from the same variables and
inputs, with the noise injected and the draw-free settings (no DiffAugment,
no temporal scale augment, no random temporal translate), so that no random
draw differs between the frameworks: losses within rtol 1e-3, parameter
gradients within 1e-3 of each tensor's max |JAX gradient| (the augmentations
are held to the JAX package's with injected draws in
tests/test_torch_lres_augment.py). Then the port's whole update cycle on its
own, with every augmentation and gradient accumulation on."""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from long_video_gan_tpu.train.gan_lres import LowResVideoGAN as JaxLowResVideoGAN
from long_video_gan_tpu_torch.io.convert_torch import flax_path_to_torch_key, load_jax_variables
from long_video_gan_tpu_torch.models import discriminator_lres
from long_video_gan_tpu_torch.ops import bias_act
from long_video_gan_tpu_torch.train import stats
from long_video_gan_tpu_torch.train.gan_lres import LowResVideoGAN
from test_torch_generators import random_variables
from test_torch_train import RTOL, _assert_grads_match, _zero_grads

LRES_CFG = dict(
    seq_length=8, height=18, width=32, total_batch=8,
    G_random_temp_translate=True, temp_scale_augment=1.0,
    G_kwargs=dict(temporal_emb_dim=64, latent_w_dim=64, temporal_padding=2, channel_max=32,
                  embedding_kwargs=dict(min_sampling_rate=10, max_sampling_rate=40,
                                        blur_widths=16)),
    D_kwargs=dict(channels_max=32, epilogue_kwargs=dict(channels=64)),
    G_grad_accum=2, D_grad_accum=2,
)
# No draw that differs between the frameworks reaches a phase's numbers.
PARITY_CFG = dict(LRES_CFG, diffaug_policy="", temp_scale_augment=0.0,
                  G_random_temp_translate=False)
MICRO = 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while the module runs: the suite runs in several
    worker processes on few cores, and a torch process's default of a
    spinning thread per core each makes them stall one another."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    gan_j = JaxLowResVideoGAN(**PARITY_CFG)
    G_vars = random_variables(gan_j.G, 1, 8, seed=60)
    D_vars = random_variables(gan_j.D, jnp.zeros((1, 3, 8, 18, 32)), seed=61)
    gan_t = LowResVideoGAN(**PARITY_CFG, device="cpu")
    load_jax_variables(gan_t.G, G_vars)
    load_jax_variables(gan_t.D, D_vars)
    return gan_j, G_vars, D_vars, gan_t


def _noise(gan_t, seed):
    shape = gan_t.G.noise_shape(MICRO, gan_t.gen_seq_length)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _real(seed):
    return np.random.default_rng(seed).uniform(-1, 1, (MICRO, 3, 8, 18, 32)).astype(np.float32)


def test_G_micro_loss_and_grads_match_jax(pair):
    gan_j, G_vars, D_vars, gan_t = pair
    noise = _noise(gan_t, 62)

    def loss_j(params):
        video = gan_j.G.apply(dict(G_vars, params=params), MICRO, gan_j.gen_seq_length,
                              noise=jnp.asarray(noise))
        logits = gan_j.run_D(D_vars, jax.random.key(0), video)
        return jnp.mean(jax.nn.softplus(-logits)), logits

    (want, want_logits), grads = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        G_vars["params"])
    _zero_grads(gan_t.G, gan_t.D)
    gan_t.D.requires_grad_(False)
    loss, logits = gan_t.G_micro_loss(None, MICRO, noise=torch.from_numpy(noise))
    loss.backward()
    gan_t.D.requires_grad_(True)
    assert all(p.grad is None for p in gan_t.D.parameters())
    np.testing.assert_allclose(loss.item(), float(want), rtol=RTOL)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), rtol=RTOL,
                               atol=RTOL * float(np.abs(want_logits).max()))
    _assert_grads_match(gan_t.G, grads)


def test_D_phase_generator_and_D_loss_match_jax(pair):
    """Two micro-batches' fakes, each generator pass moving the magnitude
    EMAs from where the last left them (the JAX scan's carry), then the D
    loss on the second."""
    gan_j, G_vars, D_vars, gan_t = pair
    beta = gan_j.G_magnitude_ema_beta
    G = copy.deepcopy(gan_t.G)
    G_vars_j = G_vars
    for seed in (63, 64):
        noise = _noise(gan_t, seed)
        fake_j, new_vars = gan_j.G.apply(G_vars_j, MICRO, 8, magnitude_ema_beta=beta,
                                         noise=jnp.asarray(noise), mutable=["ema"])
        G_vars_j = dict(G_vars_j, ema=new_vars["ema"])
        gan_t.G, G_saved = G, gan_t.G
        try:
            with torch.no_grad():
                fake_t = gan_t.generate(None, MICRO, beta, noise=torch.from_numpy(noise))
        finally:
            gan_t.G = G_saved
        np.testing.assert_allclose(fake_t.numpy(), np.asarray(fake_j), rtol=RTOL,
                                   atol=2e-3 * float(np.abs(fake_j).max()))
    state = G.state_dict()
    for path, leaf in jax.tree_util.tree_flatten_with_path(G_vars_j["ema"])[0]:
        key = flax_path_to_torch_key(tuple(k.key for k in path))
        np.testing.assert_allclose(state[key].numpy(), np.asarray(leaf), rtol=1e-5, atol=1e-6)
        assert not np.allclose(state[key].numpy(), gan_t.G.state_dict()[key].numpy())

    fake, real = np.asarray(fake_j), _real(65)

    def loss_j(params):
        Dv = dict(D_vars, params=params)
        fl = gan_j.run_D(Dv, jax.random.key(1), jnp.asarray(fake))
        rl = gan_j.run_D(Dv, jax.random.key(2), jnp.asarray(real))
        return jnp.mean(jax.nn.softplus(fl)) + jnp.mean(jax.nn.softplus(-rl)), (fl, rl)

    (want, (fake_j, real_j)), grads = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        D_vars["params"])
    _zero_grads(gan_t.D)
    loss, fake_l, real_l = gan_t.D_micro_loss(None, torch.from_numpy(np.array(fake)),
                                              torch.from_numpy(real))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=RTOL)
    np.testing.assert_allclose(fake_l.detach().numpy(), np.asarray(fake_j), rtol=RTOL,
                               atol=1e-4)
    np.testing.assert_allclose(real_l.detach().numpy(), np.asarray(real_j), rtol=RTOL,
                               atol=1e-4)
    _assert_grads_match(gan_t.D, grads, flax_path_to_torch_key)


def test_r1_micro_loss_and_grads_match_jax(pair):
    """R1 differentiates D twice: its 3D convs, the binomial FIRs and the
    epilogue's conv1d."""
    gan_j, G_vars, D_vars, gan_t = pair
    real = _real(66)

    def loss_j(params):
        Dv = dict(D_vars, params=params)

        def d_sum(v):
            return jnp.sum(gan_j.run_D(Dv, jax.random.key(3), v))

        r1_grads = jax.grad(d_sum)(jnp.asarray(real))
        penalty = jnp.sum(jnp.square(r1_grads), axis=(1, 2, 3, 4))
        return jnp.mean(penalty * (gan_j.r1_gamma / 2)), penalty

    (want, want_pen), grads = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        D_vars["params"])
    _zero_grads(gan_t.D)
    loss, penalty = gan_t.r1_micro_loss(None, torch.from_numpy(real))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=RTOL)
    np.testing.assert_allclose(penalty.detach().numpy(), np.asarray(want_pen), rtol=RTOL)
    _assert_grads_match(gan_t.D, grads, flax_path_to_torch_key)


def test_r1_micro_batch_matches_plain_autograd_in_float64(monkeypatch):
    """One R1 micro-batch of the tiny trainer in float64, every augmentation
    on: D's parameter gradients against the same D with `ops.conv` and
    bias_act's lrelu replaced by `F.conv{1,3}d` and `F.leaky_relu` under
    PyTorch's own autograd, to 1e-12 of each tensor's largest. The skipped
    weight gradients and gradients of zeros change no value: a parameter that
    no gradient reaches (None, which the optimizer reads as zeros) has a
    plain gradient of exactly zero."""
    gan = LowResVideoGAN(**LRES_CFG, device="cpu")
    gan.init_state(torch.Generator().manual_seed(2))
    gan.D.double()
    for block in gan.D.blocks:     # the blocks and the epilogue cast to float32
        block.use_fp16, block.half_dtype = True, torch.float64
    to_float = torch.Tensor.float
    monkeypatch.setattr(torch.Tensor, "float",
                        lambda t: t if t.dtype == torch.float64 else to_float(t))
    real = torch.from_numpy(np.random.default_rng(68).uniform(-1, 1, (MICRO, 3, 8, 18, 32)))

    def grads():
        gan.D.zero_grad(set_to_none=True)
        loss, _ = gan.r1_micro_loss(torch.Generator().manual_seed(3), real)
        assert loss.dtype == torch.float64
        loss.backward()
        return loss.item(), {k: p.grad for k, p in gan.D.named_parameters()}

    loss, got = grads()
    plain_conv = {1: torch.nn.functional.conv1d, 3: torch.nn.functional.conv3d}
    monkeypatch.setattr(discriminator_lres, "conv", lambda x, w, padding: plain_conv[
        len(padding)](x, w, padding=tuple(padding)))
    monkeypatch.setitem(bias_act.activation_funcs, "lrelu", bias_act.ActivationSpec(
        lambda x, alpha: torch.nn.functional.leaky_relu(x, alpha), 0.2, np.sqrt(2.0)))
    want_loss, want = grads()
    assert loss == want_loss
    params = dict(gan.D.named_parameters())
    dense = lambda g, name: g if g is not None else torch.zeros_like(params[name])  # noqa: E731
    assert sum(g is None for g in got.values()) > sum(g is None for g in want.values())
    for name in params:
        g, w = dense(got[name], name), dense(want[name], name)
        assert float((g - w).abs().max()) <= 1e-12 * float(w.abs().max()), name


def test_lres_full_step_cycle():
    """update_G -> update_D -> update_r1 -> update_G_ema on the port alone,
    with DiffAugment, the temporal scale augment, the random temporal
    translate and gradient accumulation, as tests/test_train_steps.py runs
    the JAX trainer."""
    gan = LowResVideoGAN(**LRES_CFG, device="cpu")
    gan.init_state(torch.Generator().manual_seed(0))
    assert gan.gen_seq_length == 8 + gan.G.total_temporal_scale
    gen = torch.Generator().manual_seed(1)
    collector = stats.Collector()
    real = torch.from_numpy(np.random.default_rng(67).uniform(
        -1, 1, (8, 3, 8, 18, 32)).astype(np.float32))

    def snapshot(module):
        return {k: v.clone() for k, v in module.state_dict().items()}

    G0, D0, E0 = snapshot(gan.G), snapshot(gan.D), snapshot(gan.G_ema)
    collector.report(gan.update_G(gen))
    assert all(p.grad is None for p in gan.G.parameters())
    assert all(p.requires_grad for p in gan.D.parameters())
    G1 = snapshot(gan.G)
    collector.report(gan.update_D(gen, real))
    collector.report(gan.update_r1(gen, real, gain=16.0))
    assert all(p.grad is None for p in gan.D.parameters())
    gan.update_G_ema()
    collector.update()

    def changed(before, module, keys=None):
        after = module.state_dict()
        return any(not torch.equal(before[k], after[k]) for k in (keys or before))

    assert gan.step == 1 and gan.opt_G.count == 1 and gan.opt_D.count == 2
    for name in ("loss/G_loss", "loss/D_loss", "loss/r1_penalty", "loss/D_score_real"):
        assert np.isfinite(collector.mean(name)), name
    params_G = [k for k, _ in gan.G.named_parameters()]
    assert changed(G0, gan.G, params_G)
    assert changed(D0, gan.D, [k for k, _ in gan.D.named_parameters()])
    assert changed(E0, gan.G_ema, params_G)
    emas = [k for k in G0 if k.endswith("magnitude_ema")]
    # The G phase leaves the magnitude EMAs; the D phase moves every one.
    assert emas and all(torch.equal(G0[k], G1[k]) for k in emas)
    assert all(changed(G1, gan.G, [k]) for k in emas)
    assert all(changed(E0, gan.G_ema, [k]) for k in emas)
