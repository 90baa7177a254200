"""Shared training machinery: the optimizer, gradient hygiene, EMA, and the
lres trainer's temporal augmentations.

Counterpart of `long_video_gan_tpu/train/common.py`. The augmentations take
their random draws as optional tensors, so a test can feed them the draws the
JAX functions made from their keys; without them they draw from a
`torch.Generator`.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.utils.checkpoint

from ..parallel.mesh import global_draw


class Adam:
    """Adam(b1=0, b2, eps=1e-8) over a list of parameters, with the learning
    rate given at each step: `optax.adam` under `inject_hyperparams`, as the
    JAX package's `make_adam` builds it. With b1 = 0 the first moment is the
    gradient itself: `mu` holds the last step's gradients, which the update
    never reads, so that a train checkpoint carries optax's whole state.
    `lrate` is the last learning rate given, in float32 (optax's injected
    hyperparameter)."""

    def __init__(self, params: Iterable[torch.Tensor], beta2: float, eps: float = 1e-8,
                 lrate: float = 0.0):
        self.params = list(params)
        self.beta2, self.eps = float(beta2), float(eps)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.lrate = float(np.float32(lrate))

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], lrate: float) -> None:
        """params -= lrate * g / (sqrt(nu / (1 - b2**count)) + eps)."""
        self.count += 1
        self.lrate = float(np.float32(lrate))
        self.mu = list(grads)
        b2 = self.beta2
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        correction = 1.0 - float(torch.tensor(b2, dtype=torch.float32) ** self.count)
        denom = torch._foreach_div(self.nu, correction)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_addcdiv_(self.params, grads, denom, value=-float(lrate))


def micro_loss(remat: bool, fn, generator: Optional[torch.Generator], *args):
    """`fn(generator, *args)`, a micro-batch loss; with `remat` under
    `torch.utils.checkpoint` (non-reentrant), the JAX trainers'
    `jax.checkpoint(micro_loss)`: its activations are recomputed in the
    backward. The recompute draws what the first run drew: `generator` is
    rewound to the state the run started from, and put back after, so the
    gradient is that of the drawn augmentations and the generator ends where
    it does without `remat` (`torch.utils.checkpoint` restores only the
    global generators)."""
    if not remat:
        return fn(generator, *args)
    start = None if generator is None else generator.get_state()
    calls = []

    def run(*inputs):
        if generator is None or not calls:
            calls.append(None)
            return fn(generator, *inputs)
        resume = generator.get_state()
        generator.set_state(start)
        try:
            return fn(generator, *inputs)
        finally:
            generator.set_state(resume)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)


def warmup_lrate(base: float, step: int, warmup_steps: int) -> float:
    """lr * min((step+1)/(warmup+1), 1)."""
    return base * min((step + 1.0) / (warmup_steps + 1.0), 1.0)


def scrub_grads(grads: Sequence[torch.Tensor], gain: Optional[float] = None) -> list[torch.Tensor]:
    """Optional gain, then nan -> 0 and +-inf -> +-1e5, as the JAX package
    (and the reference's sync_grads) post-process gradients."""
    out = []
    for g in grads:
        if gain is not None:
            g = g * gain
        out.append(torch.nan_to_num(g, nan=0.0, posinf=1e5, neginf=-1e5))
    return out


def collect_grads(params: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Each parameter's accumulated .grad, zeros where none arrived."""
    return [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]


def ema_beta_schedule(step: int, ema_beta: float, warmup_steps: int) -> float:
    """Warmup-ramped EMA decay: min(ema_beta ** ((warmup+1)/(step+1)), ema_beta),
    in float32 as the JAX package computes it (at step 0 the float32 rounding
    of 0.99985, raised to the 25001st power, moves the result by 6e-4)."""
    exponent = np.float32(warmup_steps + 1.0) / np.float32(step + 1.0)
    return float(min(np.float32(ema_beta) ** exponent, np.float32(ema_beta)))


@torch.no_grad()
def lerp_trees(target: nn.Module, source: nn.Module, weight: float) -> None:
    """target += (source - target) * weight, in place over the parameters
    AND persistent buffers (magnitude EMAs, w_avg) of two modules of one
    architecture."""
    tgt = target.state_dict()
    src = source.state_dict()
    keys = [k for k, v in tgt.items() if v.is_floating_point()]
    t = [tgt[k] for k in keys]
    diff = torch._foreach_sub([src[k].to(tgt[k].dtype) for k in keys], t)
    torch._foreach_mul_(diff, float(weight))
    torch._foreach_add_(t, diff)


# ---------------------------------------------------------------------------
# Temporal augmentations used by the lres trainer.


def _uniform(generator: Optional[torch.Generator], n: int, device) -> torch.Tensor:
    if generator is None:
        raise ValueError("need the draws or a torch.Generator to draw them from")
    return global_draw(lambda m: torch.rand((m,), generator=generator,
                                            device=generator.device), n).to(device)


def random_temporal_crop(video: torch.Tensor, seq_length: int,
                         generator: Optional[torch.Generator] = None,
                         t0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample crop of `seq_length` frames from a longer [N, C, T, H, W]
    video (G_random_temp_translate), starting at frame `t0` [N] (integers in
    [0, T - seq_length]), drawn from `generator` when not given."""
    n, c, t, h, w = video.shape
    assert t >= seq_length
    if t0 is None:
        if t > seq_length:
            if generator is None:
                raise ValueError("need t0 or a torch.Generator to draw it from")
            t0 = global_draw(lambda m: torch.randint(0, t - seq_length + 1, (m,),
                                                     generator=generator,
                                                     device=generator.device), n)
        else:
            t0 = torch.zeros((n,), dtype=torch.int64)
    idx = t0.to(video.device, torch.int64)[:, None] + torch.arange(seq_length,
                                                                    device=video.device)
    return torch.take_along_dim(video, idx.view(n, 1, seq_length, 1, 1), dim=2)


def temporal_scale_augment(video: torch.Tensor, max_log2_scale: float,
                           generator: Optional[torch.Generator] = None,
                           sf: Optional[torch.Tensor] = None,
                           u_pad: Optional[torch.Tensor] = None,
                           u_crop: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample random temporal rescale of [N, C, T, H, W] videos: a
    linear time-resample by `sf` [N] (2 ** U(-s, s)), zero-padded where the
    result is shorter than T, and cropped back to T frames at a random offset
    (`u_pad`, `u_crop` [N], uniform in [0, 1)).

    The JAX package's fixed-shape form of the reference's interpolate + pad +
    crop: output frame j reads the input at (j + crop - pad + 0.5) / sf - 0.5,
    edge-clamped, as a lerp of its two neighbours, and is zero outside the
    resampled length floor(T * sf)."""
    n, c, t, h, w = video.shape
    dev = video.device
    if sf is None:
        sf = torch.exp2(_uniform(generator, n, dev) * (2 * max_log2_scale) - max_log2_scale)
    if u_pad is None:
        u_pad = _uniform(generator, n, dev)
    if u_crop is None:
        u_crop = _uniform(generator, n, dev)
    sf, u_pad, u_crop = (v.to(dev, torch.float32) for v in (sf, u_pad, u_crop))
    t_resampled = torch.floor(t * sf).to(torch.int32)           # per-sample virtual length

    pad_span = torch.clamp(t - t_resampled, min=0)
    p0 = torch.floor(u_pad * (pad_span + 1)).to(torch.int32)
    crop_span = torch.maximum(t_resampled, torch.full_like(t_resampled, t)) - t
    i0 = torch.floor(u_crop * (crop_span + 1)).to(torch.int32)

    j = torch.arange(t, device=dev, dtype=torch.int32)
    k_res = j[None, :] + i0[:, None] - p0[:, None]              # [n, t]
    valid = (k_res >= 0) & (k_res < t_resampled[:, None])
    src = (k_res.to(torch.float32) + 0.5) / sf[:, None] - 0.5
    src = torch.clamp(src, 0.0, t - 1.0)                        # edge clamp
    lo = torch.floor(src).to(torch.int64)
    hi = torch.clamp(lo + 1, max=t - 1)
    frac = (src - lo).view(n, 1, t, 1, 1).to(video.dtype)
    v_lo = torch.take_along_dim(video, lo.view(n, 1, t, 1, 1), dim=2)
    v_hi = torch.take_along_dim(video, hi.view(n, 1, t, 1, 1), dim=2)
    out = v_lo * (1 - frac) + v_hi * frac
    return out * valid.view(n, 1, t, 1, 1).to(video.dtype)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The random stream of one training step, seeded from (seed, step): the
    CLIs' counterpart of `jax.random.fold_in(base_key, step)`, so a resumed
    run draws at step s what an uninterrupted run draws there."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))
