"""Stage-1 (low-res) GAN trainer.

Benchmark reference: plain PyTorch in float32 on one process, importing only
`h100_bench.reference`. It follows the published trainer (NVlabs/long-video-gan,
`train_lres.py` and its loss) with the JAX package's numerics
(`long_video_gan_tpu/train/gan_lres.py`): the non-saturating logistic loss,
R1 on the augmented reals (gamma / 2 times the squared gradient of D's
summed logits), Adam with b1 = 0, the G_ema schedule; the train state is
held by the object and the update methods change it in place.

Each phase accumulates `*_grad_accum` micro-batches into the `.grad` of the
module it updates (the other module's parameters have `requires_grad` off),
then takes one Adam step with the gradients scaled by 1 / micro-batches
(R1 by its gain too). The D phase generates each micro-batch's fakes under
`torch.no_grad()`, moving G's magnitude EMAs by `G_magnitude_ema_beta`.

Every random draw comes from the `torch.Generator` passed in, on its device,
in the program's order: a G call's white noise, then the temporal crop of
its fakes (`G_random_temp_translate`); each D input's DiffAugment draws,
then the temporal scale augment's three (scale, pad, crop).

Departures from the program: one process (no collective); no recompute
(`remat`); the phases return their losses' moments alone.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Optional

import torch
import torch.nn.functional as F

from .diff_augment import diff_augment
from .lres_discriminator import VideoDiscriminator
from .lres_generator import VideoGenerator
from .train_common import (Adam, collect_grads, ema_beta_schedule, lerp_trees, loss_moments,
                           scrub_grads, warmup_lrate)


def _uniform(generator: torch.Generator, n: int, device) -> torch.Tensor:
    return torch.rand((n,), generator=generator, device=generator.device).to(device)


def random_temporal_crop(video: torch.Tensor, seq_length: int,
                         generator: torch.Generator) -> torch.Tensor:
    """Per clip, `seq_length` frames from a drawn start in [0, T - seq_length]."""
    n, t = video.shape[0], video.shape[2]
    if t == seq_length:
        return video
    t0 = torch.randint(0, t - seq_length + 1, (n,), generator=generator,
                       device=generator.device).to(video.device)
    idx = t0[:, None] + torch.arange(seq_length, device=video.device)
    return torch.take_along_dim(video, idx.view(n, 1, seq_length, 1, 1), dim=2)


def temporal_scale_augment(video: torch.Tensor, max_log2_scale: float,
                           generator: torch.Generator) -> torch.Tensor:
    """Per clip, time resampled linearly by sf = 2 ** U(-s, s), zero-padded
    where it comes out shorter than T and cropped back to T at drawn offsets:
    output frame j reads the input at (j + crop - pad + 0.5) / sf - 0.5,
    clamped to the clip, and is zero beyond the resampled length
    floor(T * sf)."""
    n, c, t, h, w = video.shape
    dev = video.device
    sf = torch.exp2(_uniform(generator, n, dev) * (2 * max_log2_scale) - max_log2_scale)
    u_pad = _uniform(generator, n, dev)
    u_crop = _uniform(generator, n, dev)
    length = torch.floor(t * sf).to(torch.int32)
    pad = torch.floor(u_pad * (torch.clamp(t - length, min=0) + 1)).to(torch.int32)
    crop = torch.floor(u_crop * (torch.clamp(length, min=t) - t + 1)).to(torch.int32)
    k = torch.arange(t, device=dev, dtype=torch.int32)[None, :] + crop[:, None] - pad[:, None]
    valid = (k >= 0) & (k < length[:, None])
    src = torch.clamp((k.to(torch.float32) + 0.5) / sf[:, None] - 0.5, 0.0, t - 1.0)
    lo = torch.floor(src).to(torch.int64)
    hi = torch.clamp(lo + 1, max=t - 1)
    frac = (src - lo).view(n, 1, t, 1, 1)
    v_lo = torch.take_along_dim(video, lo.view(n, 1, t, 1, 1), dim=2)
    v_hi = torch.take_along_dim(video, hi.view(n, 1, t, 1, 1), dim=2)
    return (v_lo * (1 - frac) + v_hi * frac) * valid.view(n, 1, t, 1, 1).to(video.dtype)


@dataclass
class LowResVideoGAN:
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
    r1_gamma: float = 10.0
    remat: bool = False

    temp_scale_augment: float = 0.0
    diffaug_policy: str = "color,translation,cutout"

    device: Any = None

    def __post_init__(self):
        assert not self.remat and not self.G_kwargs.get("block_remat", False)
        self.device = torch.device(self.device if self.device is not None else "cpu")
        G_kwargs = {k: v for k, v in self.G_kwargs.items() if k != "block_remat"}
        self.G = VideoGenerator(out_height=self.height, out_width=self.width, **G_kwargs,
                                device=self.device)
        self.D = VideoDiscriminator(self.seq_length, max(self.height, self.width),
                                    **self.D_kwargs, device=self.device)
        self.G_ema = copy.deepcopy(self.G).requires_grad_(False)
        self.init_state(None)

    def init_state(self, generator: Optional[torch.Generator]) -> None:
        """Copy G into G_ema and reset the optimizers and the step (the
        benchmark draws the weights: `common.draw_state`)."""
        assert generator is None
        self.G_ema.load_state_dict(self.G.state_dict())
        self.opt_G = Adam(self.G.parameters(), self.G_beta2, lrate=self.G_lrate)
        self.opt_D = Adam(self.D.parameters(), self.D_beta2, lrate=self.D_lrate)
        self.step = 0

    # ------------------------------------------------------------------ G and D runs

    def generate(self, generator: torch.Generator, n: int, beta: float = 1.0) -> torch.Tensor:
        """n fake clips of `seq_length` frames (G runs `total_temporal_scale`
        frames longer and a crop is drawn, with `G_random_temp_translate`)."""
        length = self.seq_length + (self.G.total_temporal_scale
                                    if self.G_random_temp_translate else 0)
        noise = torch.randn(self.G.noise_shape(n, length), generator=generator,
                            device=generator.device).to(self.device)
        video = self.G(noise, length, beta)
        if self.G_random_temp_translate:
            video = random_temporal_crop(video, self.seq_length, generator)
        return video

    def run_D(self, generator: torch.Generator, video: torch.Tensor) -> torch.Tensor:
        video = diff_augment(video, self.diffaug_policy, generator)
        if self.temp_scale_augment > 0:
            video = temporal_scale_augment(video, self.temp_scale_augment, generator)
        return self.D(video)

    # ------------------------------------------------------------------ phases

    def _apply(self, opt: Adam, gain: float, base_lrate: float, warmup_steps: int) -> None:
        grads = scrub_grads(collect_grads(opt.params), gain=gain)
        for p in opt.params:
            p.grad = None
        opt.step(grads, warmup_lrate(base_lrate, self.step, warmup_steps))

    def _chunks(self, x: torch.Tensor, accum: int) -> tuple[torch.Tensor, ...]:
        return x.split(x.shape[0] // accum)

    def update_G(self, generator: torch.Generator) -> dict:
        """Mean softplus(-D(G(noise))) over `G_grad_accum` micro-batches."""
        accum = self.G_grad_accum
        self.G.requires_grad_(True)
        self.D.requires_grad_(False)
        moments = torch.zeros(3, device=self.device)
        for _ in range(accum):
            logits = self.run_D(generator, self.generate(generator, self.total_batch // accum))
            loss = F.softplus(-logits).mean()
            loss.backward()
            moments = moments + loss_moments(loss)
        self.D.requires_grad_(True)
        self._apply(self.opt_G, 1.0 / accum, self.G_lrate, self.G_warmup_steps)
        return {"loss/G_loss": moments}

    def update_D(self, generator: torch.Generator, real_video: torch.Tensor) -> dict:
        """Mean softplus(D(fake)) + mean softplus(-D(real)), per micro-batch."""
        accum = self.D_grad_accum
        self.D.requires_grad_(True)
        moments = torch.zeros(3, device=self.device)
        for real in self._chunks(real_video, accum):
            with torch.no_grad():
                fake = self.generate(generator, real.shape[0], self.G_magnitude_ema_beta)
            fake_logits = self.run_D(generator, fake)
            real_logits = self.run_D(generator, real)
            loss = F.softplus(fake_logits).mean() + F.softplus(-real_logits).mean()
            loss.backward()
            moments = moments + loss_moments(loss)
        self._apply(self.opt_D, 1.0 / accum, self.D_lrate, self.D_warmup_steps)
        return {"loss/D_loss": moments}

    def update_r1(self, generator: torch.Generator, real_video: torch.Tensor,
                  gain: float = 1.0) -> dict:
        """gamma / 2 times the mean squared gradient of D's summed logits
        (augmentations included) with respect to the real clips."""
        accum = self.D_grad_accum
        self.D.requires_grad_(True)
        moments = torch.zeros(3, device=self.device)
        for video in self._chunks(real_video, accum):
            video = video.detach().requires_grad_(True)
            logits = self.run_D(generator, video)
            (grads,) = torch.autograd.grad(logits.sum(), video, create_graph=True)
            loss = (grads.square().sum(dim=(1, 2, 3, 4)) * (self.r1_gamma / 2)).mean()
            loss.backward()
            moments = moments + loss_moments(loss)
        self._apply(self.opt_D, gain / accum, self.D_lrate, self.D_warmup_steps)
        return {"loss/r1_loss": moments}

    def update_G_ema(self) -> None:
        beta = ema_beta_schedule(self.step, self.G_ema_beta, self.G_ema_warmup_steps)
        lerp_trees(self.G_ema, self.G, 1.0 - beta)
        self.step += 1
