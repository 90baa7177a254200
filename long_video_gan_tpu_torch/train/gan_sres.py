"""Stage-2 (super-res) GAN trainer.

Counterpart of `long_video_gan_tpu/train/gan_sres.py` `SuperResVideoGAN`,
with the train state held by the object: the G, G_ema and D modules, their
Adam states, `ada_p`, the real-logit sign moments that feed the ADA
controller, and the step. The update methods change that state in place and
return their statistics (moment triples, `train.stats`).

Beside what the JAX trainer does, written out for PyTorch:
  * gradient accumulation is a loop over micro-batches; each micro-batch's
    loss is backpropagated into the `.grad` of the module being updated, the
    other module's parameters having `requires_grad` off;
  * the D phase generates each micro-batch's fake hr frames under
    `torch.no_grad()`, updating G's magnitude EMAs and w_avg in place (the
    JAX `update_ema=True` generator pass), so no in-place update lands in a
    graph that autograd still needs, nor in a loss that `remat` recomputes;
  * a `torch.Generator` takes the place of each JAX key. z, the ADA and
    in_augment draws and the lr-conditioning dropout are drawn from it in the
    JAX package's order;
  * with several processes (`parallel`), each holds its share of the batch
    and the reductions the JAX mesh inserts are written out: the gradients'
    mean over the processes once per phase, the magnitude EMAs' and w_avg's
    global batch means, ADA's real-sign moments and the statistics' sums;
    every batch-leading draw is taken at the global batch size and sliced to
    the process's rows.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..models.ada_augment import AugmentPipe
from ..models.discriminator_sres import VideoDiscriminator
from ..models.generator_sres import VideoGenerator
from ..parallel import mesh
from ..utils.misc import assert_shape
from ..utils.profiling import annotate
from . import stats as stats_lib
from .common import micro_loss
from .gan import GANTrainer


@dataclass
class SuperResVideoGAN(GANTrainer):
    seq_length: int
    temporal_context: int
    lr_height: int
    lr_width: int
    hr_height: int
    hr_width: int
    channels: int = 3
    total_batch: int = 32

    G_lrate: float = 0.003
    G_beta2: float = 0.99
    G_warmup_steps: int = 0
    G_ema_beta: float = 0.99985
    G_ema_warmup_steps: int = 25000
    G_magnitude_ema_beta: float = 0.999
    G_grad_accum: int = 1
    G_kwargs: dict = field(default_factory=dict)

    D_lrate: float = 0.002
    D_beta2: float = 0.99
    D_warmup_steps: int = 0
    D_grad_accum: int = 1
    D_kwargs: dict = field(default_factory=dict)

    r1_gamma: Optional[float] = 1.0
    lr_cond_prob: float = 0.1
    # Recompute each G and D micro-batch loss in the backward (the JAX
    # `jax.checkpoint(micro_loss)`; `train.common.micro_loss`).
    remat: bool = False

    augment_p_init: float = 0.0
    augment_p_max: float = 0.5
    augment_p_update_rate: float = 0.000125
    augment_real_sign_target: Optional[float] = 0.6
    augment_kwargs: dict = field(default_factory=dict)

    in_augment_p: float = 0.5
    in_augment_strength: float = 8.0
    in_augment_margin_frac: float = 0.5

    device: Any = None

    extra_state = ("ada_p", "sign_real_moments")

    def __post_init__(self):
        self.device = torch.device(self.device if self.device is not None else "cpu")
        self.context_seq_length = self.seq_length + 2 * self.temporal_context
        self.G = VideoGenerator(
            hr_height=self.hr_height, hr_width=self.hr_width,
            lr_height=self.lr_height, lr_width=self.lr_width,
            temporal_context=self.temporal_context, **self.G_kwargs, device=self.device)
        self.D = VideoDiscriminator(
            channels=self.channels, seq_length=self.seq_length,
            lr_height=self.lr_height, lr_width=self.lr_width,
            hr_height=self.hr_height, hr_width=self.hr_width, **self.D_kwargs,
            device=self.device)
        self.G_ema = copy.deepcopy(self.G).requires_grad_(False)

        self.augment = None
        if self.augment_p_init > 0 or self.augment_real_sign_target is not None:
            self.augment = AugmentPipe(**self.augment_kwargs)

        self.in_augment = None
        if self.in_augment_strength > 0 and self.in_augment_p > 0:
            s = self.in_augment_strength
            self.in_augment = AugmentPipe(
                scale=1, scale_std=0.01 * s, rotate=1, rotate_max=0.002 * s,
                aniso=1, aniso_std=0.01 * s, xfrac=1, xfrac_std=0.002 * s,
                noise=1, noise_std=0.01 * s,
                margin_frac=self.in_augment_margin_frac)
        self.init_state(None)

    # ------------------------------------------------------------------ init

    def init_state(self, generator: Optional[torch.Generator]) -> None:
        """`GANTrainer.init_state`, and ADA's p and real-sign moments reset."""
        super().init_state(generator)
        self.ada_p = torch.tensor(self.augment_p_init, dtype=torch.float32, device=self.device)
        self.sign_real_moments = torch.zeros(3, device=self.device)

    # ------------------------------------------------------------------ run_D

    def crop_to_seq_length(self, video: torch.Tensor) -> torch.Tensor:
        t0 = (video.shape[2] - self.seq_length) // 2
        return video[:, :, t0:t0 + self.seq_length]

    def run_D(self, generator: torch.Generator, lr_video: torch.Tensor,
              hr_video: torch.Tensor) -> torch.Tensor:
        """Upsample lr, concatenate with hr on time so that ADA transforms
        both alike, split, drop the lr conditioning with 1 - lr_cond_prob,
        score."""
        assert_shape(lr_video, (None, self.channels, self.seq_length, self.lr_height,
                                self.lr_width))
        assert_shape(hr_video, (None, self.channels, self.seq_length, self.hr_height,
                                self.hr_width))
        lr_up = self.D.upsample_lr(lr_video)
        both = torch.cat([lr_up, hr_video], dim=2)
        if self.augment is not None:
            both = self.augment(generator, both, self.ada_p)
        lr_up, hr_video = both.chunk(2, dim=2)

        if self.lr_cond_prob < 1:
            draw = mesh.global_draw(lambda m: torch.rand((m, 1, 1, 1, 1), generator=generator,
                                                         device=generator.device),
                                    lr_up.shape[0]).to(lr_up.device)
            lr_up = lr_up * (draw < self.lr_cond_prob).to(lr_up.dtype)
        return self.D(lr_up, hr_video)

    def _apply_in_augment(self, generator: torch.Generator, lr_video: torch.Tensor):
        if self.in_augment is None:
            return lr_video
        return self.in_augment(generator, lr_video, self.in_augment_p)

    def _draw_z(self, generator: torch.Generator, n: int) -> torch.Tensor:
        return mesh.global_draw(lambda m: torch.randn((m, self.G.latent_z_dim),
                                                      generator=generator,
                                                      device=generator.device), n).to(self.device)

    # ------------------------------------------------------------------ losses
    # One micro-batch each: the trainer accumulates them, the tests hold them
    # against the JAX package with injected z.

    def G_micro_loss(self, generator: torch.Generator, lr_chunk: torch.Tensor,
                     z: Optional[torch.Tensor] = None):
        """(mean softplus(-D(G(lr))), logits)."""
        if z is None:
            z = self._draw_z(generator, lr_chunk.shape[0])
        hr = self.G(lr_chunk, z=z)
        logits = self.run_D(generator, self.crop_to_seq_length(lr_chunk), hr)
        return F.softplus(-logits).mean(), logits

    def D_micro_loss(self, generator: torch.Generator, fake_lr: torch.Tensor,
                     fake_hr: torch.Tensor, real_lr: torch.Tensor, real_hr: torch.Tensor):
        """(mean softplus(D(fake)) + mean softplus(-D(real)), fake logits,
        real logits)."""
        fake_logits = self.run_D(generator, fake_lr, fake_hr)
        real_logits = self.run_D(generator, real_lr, real_hr)
        loss = F.softplus(fake_logits).mean() + F.softplus(-real_logits).mean()
        return loss, fake_logits, real_logits

    def r1_micro_loss(self, generator: torch.Generator, lr: torch.Tensor, hr: torch.Tensor):
        """(mean R1 penalty * gamma / 2, per-sample penalty): the squared
        gradient of D's summed logits with respect to the hr input."""
        hr = hr.detach().requires_grad_(True)
        logits = self.run_D(generator, lr, hr)
        (r1_grads,) = torch.autograd.grad(logits.sum(), hr, create_graph=True)
        penalty = r1_grads.square().sum(dim=(1, 2, 3, 4))
        return (penalty * (self.r1_gamma / 2)).mean(), penalty

    # ------------------------------------------------------------------ steps

    def update_G(self, generator: torch.Generator, lr_video: torch.Tensor) -> dict:
        with annotate("lvg.update_G"):
            assert_shape(lr_video, (self.local_batch, self.channels, self.context_seq_length,
                                    self.lr_height, self.lr_width))
            lr_video = self._apply_in_augment(generator, lr_video)
            accum = self.G_grad_accum
            self.G.requires_grad_(True)
            self.D.requires_grad_(False)
            stats = None
            for lr_chunk in self._chunks(lr_video, accum):
                loss, logits = micro_loss(self.remat, self.G_micro_loss, generator, lr_chunk)
                loss.backward()
                stats = stats_lib.accumulate(stats, {
                    "loss/G_score": stats_lib.moments(logits),
                    "loss/G_sign": stats_lib.moments(torch.sign(logits)),
                    "loss/G_loss": stats_lib.loss_moments(loss)})
            self.D.requires_grad_(True)
            lrate = self._apply(self.opt_G, 1.0 / accum, self.G_lrate, self.G_warmup_steps)
            stats["progress/G_lrate"] = stats_lib.scalar_moments(lrate)
            return stats

    def update_D(self, generator: torch.Generator, fake_lr_video: torch.Tensor,
                 real_lr_video: torch.Tensor, real_hr_video: torch.Tensor) -> dict:
        with annotate("lvg.update_D"):
            assert_shape(fake_lr_video, (self.local_batch, self.channels, self.context_seq_length,
                                         self.lr_height, self.lr_width))
            assert_shape(real_hr_video, (self.local_batch, self.channels, self.seq_length,
                                         self.hr_height, self.hr_width))
            fake_lr_video = self._apply_in_augment(generator, fake_lr_video)
            real_lr_video = self._apply_in_augment(generator, real_lr_video)
            fake_lr_crop = self.crop_to_seq_length(fake_lr_video)
            real_lr_crop = self.crop_to_seq_length(real_lr_video)

            accum = self.D_grad_accum
            self.D.requires_grad_(True)
            stats = None
            for fl_ctx, fl, rl, rh in zip(*(self._chunks(v, accum) for v in (
                    fake_lr_video, fake_lr_crop, real_lr_crop, real_hr_video))):
                with torch.no_grad():
                    z = self._draw_z(generator, fl_ctx.shape[0])
                    fh = self.G(fl_ctx, z=z, magnitude_ema_beta=self.G_magnitude_ema_beta)
                loss, flg, rlg = micro_loss(self.remat, self.D_micro_loss, generator, fl, fh,
                                            rl, rh)
                loss.backward()
                stats = stats_lib.accumulate(stats, {
                    "loss/D_score_fake": stats_lib.moments(flg),
                    "loss/D_score_real": stats_lib.moments(rlg),
                    "loss/D_sign_fake": stats_lib.moments(torch.sign(flg)),
                    "loss/D_sign_real": stats_lib.moments(torch.sign(rlg)),
                    "loss/D_loss": stats_lib.loss_moments(loss)})
            lrate = self._apply(self.opt_D, 1.0 / accum, self.D_lrate, self.D_warmup_steps)
            # Feed the ADA controller the global batch's real-logit signs, so that
            # every process moves ada_p alike.
            self.sign_real_moments = self.sign_real_moments + mesh.all_reduce_sum_(
                [stats["loss/D_sign_real"].clone()])[0]
            stats["progress/D_lrate"] = stats_lib.scalar_moments(lrate)
            return stats

    def update_r1(self, generator: torch.Generator, lr_video: torch.Tensor,
                  hr_video: torch.Tensor, gain: float = 1.0) -> dict:
        with annotate("lvg.update_r1"):
            assert self.r1_gamma is not None
            assert_shape(lr_video, (self.local_batch, self.channels, self.seq_length,
                                    self.lr_height, self.lr_width))
            lr_video = self._apply_in_augment(generator, lr_video)
            accum = self.D_grad_accum
            self.D.requires_grad_(True)
            stats = None
            for lr, hr in zip(self._chunks(lr_video, accum), self._chunks(hr_video, accum)):
                loss, penalty = self.r1_micro_loss(generator, lr, hr)
                loss.backward()
                stats = stats_lib.accumulate(stats, {
                    "loss/r1_penalty": stats_lib.moments(penalty),
                    "loss/r1_loss": stats_lib.loss_moments(loss)})
            self._apply(self.opt_D, gain / accum, self.D_lrate, self.D_warmup_steps)
            return stats

    @torch.no_grad()
    def update_ada(self, gain: float = 1.0) -> dict:
        """Move ada_p toward the real-logit-sign target."""
        with annotate("lvg.update_ada"):
            if self.augment_real_sign_target is None:
                return {}
            count, total = self.sign_real_moments[0], self.sign_real_moments[1]
            mean_sign = torch.where(count > 0, total / torch.clamp(count, min=1.0),
                                    torch.zeros_like(total))
            direction = torch.sign(mean_sign - self.augment_real_sign_target)
            new_p = torch.clamp(self.ada_p + direction * self.augment_p_update_rate * gain,
                                0.0, self.augment_p_max)
            self.ada_p = torch.where(count > 0, new_p, self.ada_p)
            self.sign_real_moments = torch.zeros(3, device=self.device)
            return {"progress/augment_p": stats_lib.scalar_moments(self.ada_p)}
