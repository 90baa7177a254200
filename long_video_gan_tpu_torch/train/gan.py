"""What the two GAN trainers share.

`GANTrainer` is the base of `gan_lres.LowResVideoGAN` and
`gan_sres.SuperResVideoGAN`: the train state both hold (the G, G_ema and D
modules, their Adam states and the step), its initialisation, the optimizer
step that closes each phase, the micro-batch split and the G_ema update.
Each trainer is a dataclass with the fields these methods read (`total_batch`,
`G_beta2`, `G_lrate`, `D_beta2`, `D_lrate`, `G_ema_beta`,
`G_ema_warmup_steps`) that builds `G`, `D` and `G_ema` in its
`__post_init__`, and names in `extra_state` the tensors it adds to the train
state.
"""

from __future__ import annotations

from typing import ClassVar, Optional

import torch

from ..models.common import init_weights_
from ..parallel import mesh
from ..parallel.multihost import local_batch_size
from ..utils.profiling import annotate
from .common import Adam, collect_grads, ema_beta_schedule, lerp_trees, scrub_grads, warmup_lrate


class GANTrainer:
    # The float32 tensor attributes the trainer adds to the JAX package's
    # `GANState` tree, in its order after step, G, G_ema, D, opt_G and opt_D:
    # what `train.state` saves, loads and replicates beside the modules.
    extra_state: ClassVar[tuple[str, ...]] = ()

    @property
    def local_batch(self) -> int:
        """This process's share of `total_batch` (all of it in one process)."""
        return local_batch_size(self.total_batch)

    def init_state(self, generator: Optional[torch.Generator]) -> None:
        """Draw G's and D's weights from `generator` (None leaves them as
        built), copy G into G_ema, and reset the optimizers and the step."""
        if generator is not None:
            init_weights_(self.G, generator)
            init_weights_(self.D, generator)
        self.G_ema.load_state_dict(self.G.state_dict())
        self.opt_G = Adam(self.G.parameters(), self.G_beta2, lrate=self.G_lrate)
        self.opt_D = Adam(self.D.parameters(), self.D_beta2, lrate=self.D_lrate)
        self.step = 0

    def _apply(self, opt: Adam, gain: float, base_lrate: float, warmup_steps: int) -> float:
        """Scrub the accumulated gradients of `opt`'s parameters, clear
        them, and take one Adam step at the warmed-up learning rate."""
        with annotate("lvg.adam"):
            params = opt.params
            # One mean over the processes, of the micro-batch loop's sums: JAX
            # scrubs gradients that are already global means.
            grads = scrub_grads(mesh.all_reduce_mean_(collect_grads(params)), gain=gain)
            for p in params:
                p.grad = None
            lrate = warmup_lrate(base_lrate, self.step, warmup_steps)
            opt.step(grads, lrate)
            return lrate

    def _chunks(self, x: torch.Tensor, accum: int) -> tuple[torch.Tensor, ...]:
        assert x.shape[0] % accum == 0, (x.shape, accum)
        return x.split(x.shape[0] // accum)

    def update_G_ema(self) -> None:
        with annotate("lvg.update_G_ema"):
            beta = ema_beta_schedule(self.step, self.G_ema_beta, self.G_ema_warmup_steps)
            lerp_trees(self.G_ema, self.G, 1.0 - beta)
            self.step += 1
