"""Stage-1 (low-res) GAN trainer.

Counterpart of `long_video_gan_tpu/train/gan_lres.py` `LowResVideoGAN`, with
the train state held by the object: the G, G_ema and D modules, their Adam
states and the step. The update methods change that state in place and
return their statistics (moment triples, `train.stats`).

Beside what the JAX trainer does, written out for PyTorch:
  * gradient accumulation is a loop over micro-batches; each micro-batch's
    loss is backpropagated into the `.grad` of the module being updated, the
    other module's parameters having `requires_grad` off;
  * the D phase generates each micro-batch's fakes under `torch.no_grad()`
    with `magnitude_ema_beta=G_magnitude_ema_beta`, so G's magnitude EMAs
    move in place once per micro-batch, in the JAX scan's order, and never
    inside a graph that autograd still needs nor in a loss that `remat`
    recomputes;
  * a `torch.Generator` takes the place of each JAX key: the noise, the
    temporal crop and the augmentations draw from it;
  * with several processes (`parallel`), each holds its share of the batch
    and the reductions the JAX mesh inserts are written out: the gradients'
    mean over the processes once per phase, the magnitude EMAs' global
    batch mean, the statistics' sums; every batch-leading draw is taken at
    the global batch size and sliced to the process's rows.

While a profiler records, each phase opens `lvg.update_<phase>`, each
optimizer step `lvg.adam`, and each D input's augmentations (DiffAugment
and the temporal scale augment) `lvg.augment`, with its `.bwd` where the
video requires a gradient (`utils/profiling.layer_span`).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..models.diff_augment import diff_augment
from ..models.discriminator_lres import VideoDiscriminator
from ..models.generator_lres import VideoGenerator
from ..ops.conv import no_weight_gradients
from ..parallel import mesh
from ..utils.misc import assert_shape
from ..utils.profiling import annotate, layer_span
from . import stats as stats_lib
from .common import micro_loss, random_temporal_crop, temporal_scale_augment
from .gan import GANTrainer


@dataclass
class LowResVideoGAN(GANTrainer):
    seq_length: int
    height: int
    width: int
    channels: int = 3
    total_batch: int = 64

    G_lrate: float = 0.003
    G_beta2: float = 0.99
    G_warmup_steps: int = 0
    G_ema_beta: float = 0.99985
    G_ema_warmup_steps: int = 25000
    G_magnitude_ema_beta: float = 0.999
    G_grad_accum: int = 1
    G_kwargs: dict = field(default_factory=dict)
    G_random_temp_translate: bool = False

    D_lrate: float = 0.002
    D_beta2: float = 0.99
    D_warmup_steps: int = 0
    D_grad_accum: int = 1
    D_kwargs: dict = field(default_factory=dict)
    r1_gamma: Optional[float] = 10.0
    # Recompute each G and D micro-batch loss in the backward (the JAX
    # `jax.checkpoint(micro_loss)`; `train.common.micro_loss`).
    remat: bool = False

    temp_scale_augment: float = 0.0
    diffaug_policy: str = "color,translation,cutout"

    device: Any = field(kw_only=True)

    def __post_init__(self):
        assert self.total_batch % self.G_grad_accum == 0
        assert self.total_batch % self.D_grad_accum == 0
        self.device = torch.device(self.device)
        self.G = VideoGenerator(out_height=self.height, out_width=self.width, **self.G_kwargs,
                                device=self.device)
        self.D = VideoDiscriminator(seq_length=self.seq_length,
                                    max_edge=max(self.height, self.width), **self.D_kwargs,
                                    device=self.device)
        self.G_ema = copy.deepcopy(self.G).requires_grad_(False)
        self.init_state(None)

    @property
    def gen_seq_length(self) -> int:
        extra = self.G.total_temporal_scale if self.G_random_temp_translate else 0
        return self.seq_length + extra

    # ------------------------------------------------------------------ D run

    def run_D(self, generator: Optional[torch.Generator], video: torch.Tensor) -> torch.Tensor:
        """DiffAugment, then the temporal-scale augment (if on), then D."""
        assert_shape(video, (None, self.channels, self.seq_length, self.height, self.width))
        return self.D(layer_span("lvg.augment", self._augment, video, generator))

    def _augment(self, video: torch.Tensor, generator: Optional[torch.Generator]
                 ) -> torch.Tensor:
        video = diff_augment(video, self.diffaug_policy, generator)
        if self.temp_scale_augment > 0:
            video = temporal_scale_augment(video, self.temp_scale_augment, generator)
        return video

    def generate(self, generator: Optional[torch.Generator], batch_size: int,
                 magnitude_ema_beta: float = 1.0, noise: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
        """Fake videos of `gen_seq_length` frames from injected white `noise`
        or noise drawn from `generator`, cropped to `seq_length` at random
        when G_random_temp_translate is on."""
        if noise is None and generator is not None:
            shape = self.G.noise_shape(1, self.gen_seq_length)[1:]
            noise = mesh.global_draw(lambda m: torch.randn((m,) + shape, generator=generator,
                                                           device=generator.device), batch_size)
        video = self.G(batch_size, self.gen_seq_length, magnitude_ema_beta=magnitude_ema_beta,
                       noise=noise, generator=generator)
        if self.G_random_temp_translate:
            video = random_temporal_crop(video, self.seq_length, generator)
        return video

    # ------------------------------------------------------------------ losses
    # One micro-batch each: the trainer accumulates them, the tests hold them
    # against the JAX package with injected noise.

    def G_micro_loss(self, generator: Optional[torch.Generator], batch_size: int,
                     noise: Optional[torch.Tensor] = None):
        """(mean softplus(-D(G(noise))), logits)."""
        logits = self.run_D(generator, self.generate(generator, batch_size, noise=noise))
        return F.softplus(-logits).mean(), logits

    def D_micro_loss(self, generator: Optional[torch.Generator], fake: torch.Tensor,
                     real: torch.Tensor):
        """(mean softplus(D(fake)) + mean softplus(-D(real)), fake logits,
        real logits)."""
        fake_logits = self.run_D(generator, fake)
        real_logits = self.run_D(generator, real)
        loss = F.softplus(fake_logits).mean() + F.softplus(-real_logits).mean()
        return loss, fake_logits, real_logits

    def r1_micro_loss(self, generator: Optional[torch.Generator], video: torch.Tensor):
        """(mean R1 penalty * gamma / 2, per-sample penalty): the squared
        gradient of D's summed logits, augmentations included, with respect
        to the real video. The gradient's graph holds no weight gradient of
        D's convolutions (`ops.conv.no_weight_gradients`): nothing reads
        one, and the loss's backward still differentiates it in D's
        weights."""
        video = video.detach().requires_grad_(True)
        logits = self.run_D(generator, video)
        with no_weight_gradients():
            (r1_grads,) = torch.autograd.grad(logits.sum(), video, create_graph=True)
        penalty = r1_grads.square().sum(dim=(1, 2, 3, 4))
        return (penalty * (self.r1_gamma / 2)).mean(), penalty

    # ------------------------------------------------------------------ steps

    def update_G(self, generator: torch.Generator) -> dict:
        with annotate("lvg.update_G"):
            accum = self.G_grad_accum
            micro = self.local_batch // accum
            self.G.requires_grad_(True)
            self.D.requires_grad_(False)
            stats = None
            try:
                for _ in range(accum):
                    loss, logits = micro_loss(self.remat, self.G_micro_loss, generator, micro)
                    loss.backward()
                    stats = stats_lib.accumulate(stats, {
                        "loss/G_score": stats_lib.moments(logits),
                        "loss/G_sign": stats_lib.moments(torch.sign(logits)),
                        "loss/G_loss": stats_lib.loss_moments(loss)})
            finally:
                self.D.requires_grad_(True)
            lrate = self._apply(self.opt_G, 1.0 / accum, self.G_lrate, self.G_warmup_steps)
            stats["progress/G_lrate"] = stats_lib.scalar_moments(lrate)
            return stats

    def update_D(self, generator: torch.Generator, real_video: torch.Tensor) -> dict:
        with annotate("lvg.update_D"):
            assert_shape(real_video, (self.local_batch, self.channels, self.seq_length,
                                      self.height, self.width))
            accum = self.D_grad_accum
            self.D.requires_grad_(True)
            stats = None
            for real in self._chunks(real_video, accum):
                # Each micro-batch's fakes, moving G's magnitude EMAs in place.
                with torch.no_grad():
                    fake = self.generate(generator, real.shape[0], self.G_magnitude_ema_beta)
                loss, flg, rlg = micro_loss(self.remat, self.D_micro_loss, generator, fake, real)
                loss.backward()
                stats = stats_lib.accumulate(stats, {
                    "loss/D_score_fake": stats_lib.moments(flg),
                    "loss/D_score_real": stats_lib.moments(rlg),
                    "loss/D_sign_fake": stats_lib.moments(torch.sign(flg)),
                    "loss/D_sign_real": stats_lib.moments(torch.sign(rlg)),
                    "loss/D_loss": stats_lib.loss_moments(loss)})
            lrate = self._apply(self.opt_D, 1.0 / accum, self.D_lrate, self.D_warmup_steps)
            stats["progress/D_lrate"] = stats_lib.scalar_moments(lrate)
            return stats

    def update_r1(self, generator: torch.Generator, real_video: torch.Tensor,
                  gain: float = 1.0) -> dict:
        with annotate("lvg.update_r1"):
            assert self.r1_gamma is not None
            accum = self.D_grad_accum
            self.D.requires_grad_(True)
            stats = None
            for video in self._chunks(real_video, accum):
                loss, penalty = self.r1_micro_loss(generator, video)
                loss.backward()
                stats = stats_lib.accumulate(stats, {
                    "loss/r1_penalty": stats_lib.moments(penalty),
                    "loss/r1_loss": stats_lib.loss_moments(loss)})
            self._apply(self.opt_D, gain / accum, self.D_lrate, self.D_warmup_steps)
            return stats
