"""The port's sres trainer against the JAX package's, on the CPU, at
tests/test_train_steps.py's tiny SRES_CFG.

One micro-batch of each phase (G loss, D loss with the D-phase generator pass
that moves the magnitude EMAs, R1 penalty) from the same variables and inputs,
with z injected, ADA at p = 0 (every stage draws but keeps the identity),
in_augment off and lr_cond_prob 1, so that no random draw differs between the
frameworks: losses within rtol 1e-3, parameter gradients within 1e-3 of each
tensor's max |JAX gradient|. Then Adam against optax, the EMA lerp and its
beta schedule, the Collector, and the port's whole update cycle on its own.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from long_video_gan_tpu.io.convert_torch import flax_path_to_torch_key
from long_video_gan_tpu.train import common as jax_common
from long_video_gan_tpu.train import stats as jax_stats
from long_video_gan_tpu.train.gan_sres import SuperResVideoGAN as JaxSuperResVideoGAN
from long_video_gan_tpu_torch.io.convert_torch import load_jax_variables
from long_video_gan_tpu_torch.train import common, stats
from long_video_gan_tpu_torch.train.gan_sres import SuperResVideoGAN
from test_torch_generators import random_variables

SRES_CFG = dict(
    seq_length=2, temporal_context=2, lr_height=9, lr_width=16,
    hr_height=36, hr_width=64, total_batch=8,
    G_kwargs=dict(latent_z_dim=32, latent_w_dim=32, margin_size=4, num_fp16_res=0,
                  channel_base=1024, channel_max=32, num_layers=6),
    D_kwargs=dict(channels_base=512, channels_max=32, num_fp16_res=0),
    augment_kwargs=dict(xflip=1, rotate90=1, xint=1, scale=1, rotate=1, aniso=1,
                        xfrac=1, brightness=1, contrast=1, lumaflip=1, hue=1,
                        saturation=1),
)
# No draw that differs between the frameworks reaches a phase's numbers.
PARITY_CFG = dict(SRES_CFG, in_augment_strength=0, lr_cond_prob=1.0)
MICRO = 4
RTOL = 1e-3


@pytest.fixture(scope="module")
def pair():
    gan_j = JaxSuperResVideoGAN(**PARITY_CFG)
    G_vars = random_variables(gan_j.G, jnp.zeros((1, 3, 6, 9, 16)), seed=30)
    D_vars = random_variables(gan_j.D, jnp.zeros((1, 3, 2, 9, 16)), jnp.zeros((1, 3, 2, 36, 64)),
                              seed=31)
    gan_t = SuperResVideoGAN(**PARITY_CFG)
    load_jax_variables(gan_t.G, G_vars)
    load_jax_variables(gan_t.D, D_vars)
    return gan_j, G_vars, D_vars, gan_t


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _assert_grads_match(module, jax_grads, to_key=flax_path_to_torch_key):
    """Every parameter's .grad within RTOL of max|JAX gradient| of that
    tensor (floored at 1e-6 of the largest gradient, for near-zero ones).
    `to_key` maps a JAX parameter path to a torch key: by default the JAX
    package's own mapping, independent of the port's."""
    want = {to_key(tuple(k.key for k in path)): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jax_grads)[0]}
    # A parameter that R1's second order does not reach (an output bias) has
    # no .grad in torch and a zero gradient in JAX.
    got = {name: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
           for name, p in module.named_parameters()}
    assert got.keys() == want.keys()
    floor = 1e-6 * max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        err = float(np.abs(got[name] - w).max())
        assert err <= RTOL * max(float(np.abs(w).max()), floor), (name, err)


def _zero_grads(*modules):
    for m in modules:
        for p in m.parameters():
            p.grad = None


def test_G_micro_loss_and_grads_match_jax(pair):
    gan_j, G_vars, D_vars, gan_t = pair
    lr, z = _inputs(40, (MICRO, 3, 6, 9, 16), (MICRO, 32))

    def loss_j(params):
        hr = gan_j.G.apply(dict(G_vars, params=params), jnp.asarray(lr), z=jnp.asarray(z))
        logits = gan_j.run_D(D_vars, jax.random.key(0), 0.0,
                             gan_j.crop_to_seq_length(jnp.asarray(lr)), hr)
        return jnp.mean(jax.nn.softplus(-logits)), logits

    (want, want_logits), grads = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        G_vars["params"])
    _zero_grads(gan_t.G, gan_t.D)
    gan_t.D.requires_grad_(False)
    loss, logits = gan_t.G_micro_loss(torch.Generator(), torch.from_numpy(lr),
                                      z=torch.from_numpy(z))
    loss.backward()
    gan_t.D.requires_grad_(True)
    np.testing.assert_allclose(loss.item(), float(want), rtol=RTOL)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), rtol=RTOL,
                               atol=RTOL * float(np.abs(want_logits).max()))
    _assert_grads_match(gan_t.G, grads)


def test_D_phase_generator_and_D_loss_match_jax(pair):
    gan_j, G_vars, D_vars, gan_t = pair
    fl_ctx, z, rl, rh = _inputs(41, (MICRO, 3, 6, 9, 16), (MICRO, 32), (MICRO, 3, 2, 9, 16),
                                (MICRO, 3, 2, 36, 64))
    # The D phase's generator pass: fake hr frames, and the EMAs it moves.
    fh_j, new_vars = gan_j.G.apply(G_vars, jnp.asarray(fl_ctx), z=jnp.asarray(z),
                                   magnitude_ema_beta=gan_j.G_magnitude_ema_beta,
                                   mutable=["ema"])
    G = SuperResVideoGAN(**PARITY_CFG).G
    G.load_state_dict(gan_t.G.state_dict())
    with torch.no_grad():
        fh_t = G(torch.from_numpy(fl_ctx), z=torch.from_numpy(z),
                 magnitude_ema_beta=gan_t.G_magnitude_ema_beta)
    np.testing.assert_allclose(fh_t.numpy(), np.asarray(fh_j), rtol=RTOL,
                               atol=2e-3 * float(np.abs(fh_j).max()))
    state = G.state_dict()
    for path, leaf in jax.tree_util.tree_flatten_with_path(new_vars["ema"])[0]:
        key = flax_path_to_torch_key(tuple(k.key for k in path))
        np.testing.assert_allclose(state[key].numpy(), np.asarray(leaf), rtol=1e-5, atol=1e-6)
    assert not np.allclose(state[key].numpy(), gan_t.G.state_dict()[key].numpy())

    fl = fl_ctx[:, :, 2:4]
    fh = np.asarray(fh_j)

    def loss_j(params):
        Dv = dict(D_vars, params=params)
        fake = gan_j.run_D(Dv, jax.random.key(1), 0.0, jnp.asarray(fl), jnp.asarray(fh))
        real = gan_j.run_D(Dv, jax.random.key(2), 0.0, jnp.asarray(rl), jnp.asarray(rh))
        return jnp.mean(jax.nn.softplus(fake)) + jnp.mean(jax.nn.softplus(-real)), (fake, real)

    (want, (fake_j, real_j)), grads = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        D_vars["params"])
    _zero_grads(gan_t.D)
    loss, fake_t, real_t = gan_t.D_micro_loss(
        torch.Generator(), *(torch.from_numpy(np.array(a)) for a in (fl, fh, rl, rh)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=RTOL)
    np.testing.assert_allclose(fake_t.detach().numpy(), np.asarray(fake_j), rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(real_t.detach().numpy(), np.asarray(real_j), rtol=RTOL, atol=1e-4)
    _assert_grads_match(gan_t.D, grads)


def test_r1_micro_loss_and_grads_match_jax(pair):
    """R1 differentiates D twice, through the ADA warp (grid_sample, the
    reflect pad, the FIR resamplers) at p = 0."""
    gan_j, G_vars, D_vars, gan_t = pair
    lr, hr = _inputs(42, (MICRO, 3, 2, 9, 16), (MICRO, 3, 2, 36, 64))

    def loss_j(params):
        Dv = dict(D_vars, params=params)

        def d_sum(h):
            return jnp.sum(gan_j.run_D(Dv, jax.random.key(3), 0.0, jnp.asarray(lr), h))

        r1_grads = jax.grad(d_sum)(jnp.asarray(hr))
        penalty = jnp.sum(jnp.square(r1_grads), axis=(1, 2, 3, 4))
        return jnp.mean(penalty * (gan_j.r1_gamma / 2)), penalty

    (want, want_pen), grads = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        D_vars["params"])
    _zero_grads(gan_t.D)
    loss, penalty = gan_t.r1_micro_loss(torch.Generator(), torch.from_numpy(lr),
                                        torch.from_numpy(hr))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=RTOL)
    np.testing.assert_allclose(penalty.detach().numpy(), np.asarray(want_pen), rtol=RTOL)
    _assert_grads_match(gan_t.D, grads)


def test_adam_matches_optax():
    rng = np.random.default_rng(43)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    steps = [({k: (rng.standard_normal(v.shape) * s).astype(np.float32)
               for k, v in params.items()}, lr)
             for s, lr in ((1.0, 0.003), (0.01, 0.001), (3.0, 0.002))]
    opt = jax_common.make_adam(0.003, 0.99)
    p_j = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(p_j)
    p_t = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    adam = common.Adam(p_t.values(), 0.99)
    for grads, lr in steps:
        p_j, state = jax_common.apply_updates(p_j, {k: jnp.asarray(v) for k, v in grads.items()},
                                              opt, state, lr)
        adam.step([torch.from_numpy(grads[k]) for k in p_t], lr)
        for k in params:
            np.testing.assert_allclose(p_t[k].numpy(), np.asarray(p_j[k]), rtol=1e-6, atol=1e-7)


def test_grad_hygiene_and_schedules_match_jax():
    g = np.array([1.0, np.nan, np.inf, -np.inf, -2.0], np.float32)
    want = np.asarray(jax_common.scrub_grads([jnp.asarray(g)], gain=0.5)[0])
    got = common.scrub_grads([torch.from_numpy(g)], gain=0.5)[0].numpy()
    np.testing.assert_array_equal(got, want)
    for step in (0, 1, 7, 100, 24999, 10_000_000):
        np.testing.assert_allclose(common.ema_beta_schedule(step, 0.99985, 25000),
                                   float(jax_common.ema_beta_schedule(jnp.asarray(step),
                                                                      0.99985, 25000)),
                                   rtol=1e-6)
        for warmup in (0, 10):
            assert common.warmup_lrate(0.003, step, warmup) == pytest.approx(
                float(jax_common.warmup_lrate(0.003, jnp.asarray(step), warmup)), rel=1e-6)


def test_ema_lerp_matches_jax(pair):
    gan_j, G_vars, _, gan_t = pair
    ema_vars = random_variables(gan_j.G, jnp.zeros((1, 3, 6, 9, 16)), seed=32)
    weight = 1.0 - common.ema_beta_schedule(3, 0.99985, 25000)
    want = jax_common.lerp_trees(ema_vars, G_vars, weight)
    G_ema = SuperResVideoGAN(**PARITY_CFG).G_ema
    load_jax_variables(G_ema, ema_vars)
    common.lerp_trees(G_ema, gan_t.G, weight)
    state = G_ema.state_dict()
    leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    assert {"ema", "params"} <= {path[0].key for path, _ in leaves}
    for path, leaf in leaves:
        key = flax_path_to_torch_key(tuple(k.key for k in path[1:]))
        np.testing.assert_allclose(state[key].numpy(), np.asarray(leaf), rtol=1e-6, atol=1e-6)


def test_collector_matches_jax():
    rng = np.random.default_rng(44)
    c_j, c_t = jax_stats.Collector(regex="loss/.*"), stats.Collector(regex="loss/.*")
    for window in range(3):
        for _ in range(window + 1):
            x = rng.standard_normal(7).astype(np.float32)
            v = float(rng.standard_normal())
            c_j.report({"loss/x": jax_stats.moments(jnp.asarray(x)),
                        "loss/v": jax_stats.scalar_moments(v), "other": jax_stats.moments(1.0)})
            c_t.report({"loss/x": stats.moments(torch.from_numpy(x)),
                        "loss/v": stats.scalar_moments(v), "other": stats.moments(torch.ones(1))})
        c_j.update()
        c_t.update()
        want, got = c_j.as_dict(), c_t.as_dict()
        assert got.keys() == want.keys() == {"loss/x", "loss/v"}
        for name in want:
            for field in ("mean", "std", "num"):
                assert got[name][field] == pytest.approx(want[name][field], rel=1e-5, abs=1e-6)
        assert c_t["loss/x"] == pytest.approx(c_j["loss/x"], rel=1e-5)
    assert np.isnan(c_t.mean("missing")) and c_t.std("missing") == 0.0


def test_sres_full_step_cycle():
    """update_G -> update_D -> update_r1 -> update_ada -> update_G_ema on the
    port alone, with ADA, in_augment, lr-conditioning dropout and gradient
    accumulation, as tests/test_train_steps.py runs the JAX trainer."""
    gan = SuperResVideoGAN(**SRES_CFG, G_grad_accum=2, D_grad_accum=2)
    gan.init_state(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    collector = stats.Collector()
    fake_lr, real_lr, real_hr, r1_lr = (torch.from_numpy(a) for a in _inputs(
        45, (8, 3, 6, 9, 16), (8, 3, 6, 9, 16), (8, 3, 2, 36, 64), (8, 3, 2, 9, 16)))

    def snapshot(module):
        return {k: v.clone() for k, v in module.state_dict().items()}

    G0, D0, E0 = snapshot(gan.G), snapshot(gan.D), snapshot(gan.G_ema)
    collector.report(gan.update_G(gen, fake_lr))
    assert all(p.grad is None for p in gan.G.parameters())
    collector.report(gan.update_D(gen, fake_lr, real_lr, real_hr))
    assert float(gan.sign_real_moments[0]) == 8
    collector.report(gan.update_r1(gen, r1_lr, real_hr, gain=16.0))
    collector.report(gan.update_ada(gain=4.0))
    gan.update_G_ema()
    collector.update()

    def changed(before, module, keys=None):
        after = module.state_dict()
        return any(not torch.equal(before[k], after[k]) for k in (keys or before))

    assert gan.step == 1
    for name in ("loss/G_loss", "loss/D_loss", "loss/r1_penalty", "loss/D_sign_real"):
        assert np.isfinite(collector.mean(name)), name
    params_G = [k for k, _ in gan.G.named_parameters()]
    assert changed(G0, gan.G, params_G)
    assert changed(D0, gan.D, [k for k, _ in gan.D.named_parameters()])
    assert changed(E0, gan.G_ema, params_G)
    emas = [k for k in G0 if k.endswith("magnitude_ema") or k.endswith("w_avg")]
    assert emas and all(changed(G0, gan.G, [k]) for k in emas)
    assert all(changed(E0, gan.G_ema, [k]) for k in emas)
    # The ADA controller moved p off 0 (the sign mean is +-1-ish), and reset.
    assert float(gan.ada_p) != 0.0 or collector.mean("loss/D_sign_real") <= 0.6
    assert float(gan.sign_real_moments.abs().sum()) == 0.0
