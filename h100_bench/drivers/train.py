"""Training cycles: the `train` traffic driver, for the sres trainer.

One object is built at set-up: the program's trainer (`train/gan_sres.py`
`SuperResVideoGAN`) with the configuration's keyword arguments, the benchmark's weights and a pool of
synthetic batches drawn on the card from the seed. Set-up drives it through
its first `checked_steps` cycles, which warm every shape, and hands the same
object to the window. A cycle is the trainers' cadence at index i: update_G,
update_D, update_r1 where i % r1_interval == 0, update_ada where
i % ada_interval == 0, update_G_ema; the window's index starts at 0
again, so it holds the R1 step. Every cycle ends in torch.cuda.synchronize().

`correct`: the reference trainer (`h100_bench/reference/gan_sres.py`, plain
PyTorch, TF32 off) follows the checked cycles from the same weights, batches
and random draws (the same seeded generators, drawn in the same order).
Compared, by the worst case: each phase's loss of each cycle; each leaf's
gradient norm as the optimizer got it in cycle 0 (Adam's first moment, b1 = 0,
after update_G, update_D and update_r1); each leaf's change over the checked
cycles in G, D and G_ema. A norm's gap is measured against the reference's
norm of that leaf or of the median leaf, the larger. Leaves whose reference
gradient is under a thousandth of the median leaf's move under Adam by
rounding alone and are left out of the change. The control puts the
reference, run with its float32 operands rounded to bfloat16, in the
program's place and compares it with the reference at full precision.
"""

from __future__ import annotations

import copy
import time

import torch

from ..common import Run, draw_state, finite, release, seeded, sync
from ..reference import ops as ref_ops

PHASES = ("update_G", "update_D", "update_r1")
LOSS_KEYS = {"update_G": "loss/G_loss", "update_D": "loss/D_loss", "update_r1": "loss/r1_loss"}
TINY_GRAD = 1e-3


def _program_gan(kwargs: dict, device):
    from long_video_gan_tpu_torch.train.gan_sres import SuperResVideoGAN

    return SuperResVideoGAN(**copy.deepcopy(kwargs), device=device)


def _reference_gan(kwargs: dict, device):
    from ..reference.gan_sres import SuperResVideoGAN

    kwargs = copy.deepcopy(kwargs)
    kwargs["G_kwargs"].pop("resample_impl", None)
    return SuperResVideoGAN(**kwargs, device=device)


def _norms(tensors) -> torch.Tensor:
    return torch.stack([t.detach().float().norm() for t in tensors])


def _norm_gap(got: torch.Tensor, want: torch.Tensor, keep=None, reduce=torch.max) -> float:
    """The worst (or `reduce`d) leaf's |got - want| / max(want, median(want))."""
    if keep is not None:
        got, want = got[keep], want[keep]
    if want.numel() == 0:
        return 0.0
    scale = torch.maximum(want, want.median())
    gaps = ((got - want).abs() / scale).nan_to_num(nan=float("inf"))
    return finite(float(reduce(gaps)))


class Driver:
    def __init__(self, run: Run):
        self.run = run
        self.kwargs = run.config["gan"]
        self.cadence = run.config["cadence"]
        self.traffic = run.traffic
        self.checked = self.traffic["checked_steps"]

    # -- data ------------------------------------------------------------------

    def _pool(self) -> list:
        """`pool_batches` distinct synthetic batches on the card, clamped
        N(0, 0.5^2): lr clips with their context and hr clips."""
        k, dev = self.kwargs, self.run.device
        g = seeded(self.run.seed, "data", dev)

        def draw(*shape):
            return torch.randn(shape, generator=g, device=dev).mul_(0.5).clamp_(-1, 1)

        n = k["total_batch"]
        t = k["seq_length"] + 2 * k["temporal_context"]
        return [(draw(n, 3, t, k["lr_height"], k["lr_width"]),
                 draw(n, 3, k["seq_length"], k["hr_height"], k["hr_width"]))
                for _ in range(self.traffic["pool_batches"])]

    def _phases(self, gan, pool, i: int, batch: int):
        """[(name, fn(generator))] of cycle index `i`, reading the pool from
        batch number `batch` on; and the next batch number."""
        take = lambda j: pool[j % len(pool)]  # noqa: E731
        (lr_g, _), (lr, hr), (lr_r1, hr_r1) = take(batch), take(batch + 1), take(batch + 2)
        phases = [("update_G", lambda g: gan.update_G(g, lr_g)),
                  ("update_D", lambda g: gan.update_D(g, lr, lr, hr))]
        if i % self.cadence["r1_interval"] == 0:
            phases.append(("update_r1", lambda g: gan.update_r1(
                g, gan.crop_to_seq_length(lr_r1), hr_r1,
                gain=float(self.cadence["r1_interval"]))))
        if i % self.cadence["ada_interval"] == 0:
            phases.append(("update_ada", lambda g: gan.update_ada(
                gain=float(self.cadence["ada_interval"]))))
        phases.append(("update_G_ema", lambda g: gan.update_G_ema()))
        return phases, batch + 3

    # -- the checked cycles --------------------------------------------------------

    def _checked_cycles(self, gan, pool) -> dict:
        """Run the first `checked` cycles; record each phase's loss, the
        cycle-0 gradient norms per leaf and the change norms per leaf."""
        start = {name: [p.detach().clone() for p in getattr(gan, name).parameters()]
                 for name in ("G", "D", "G_ema")}
        losses, grads = {phase: [] for phase in PHASES}, {}
        batch = 0
        for i in range(self.checked):
            phases, batch = self._phases(gan, pool, i, batch)
            generator = seeded(self.run.seed, f"cycle{i}", self.run.device)
            for name, fn in phases:
                stats = fn(generator)
                if name in LOSS_KEYS:
                    m = stats[LOSS_KEYS[name]]
                    losses[name].append(float(m[1] / m[0]))
                    if i == 0:
                        opt = gan.opt_G if name == "update_G" else gan.opt_D
                        grads[name] = _norms(opt.mu).cpu()
        sync(self.run.device)
        change = {name: _norms([p.detach() - p0 for p, p0 in
                                zip(getattr(gan, name).parameters(), start[name])]).cpu()
                  for name in start}
        return {"losses": losses, "grads": grads, "change": change}

    # -- set-up ----------------------------------------------------------------

    def setup(self) -> None:
        dev = self.run.device
        cpu_ref = _reference_gan_modules(self.kwargs)
        self.states = {name: draw_state(module, self.run.seed, dev, f"weights.{name}")
                       for name, module in cpu_ref.items()}
        del cpu_ref
        self.gan = gan = _program_gan(self.kwargs, dev)
        gan.G.load_state_dict(self.states["G"])
        gan.D.load_state_dict(self.states["D"])
        gan.init_state(None)
        self.pool = self._pool()
        self.program = self._checked_cycles(gan, self.pool)
        self.batch = 0

    # -- the window ------------------------------------------------------------

    def _cycle(self, i: int, phase_s: dict | None = None, spans: bool = False) -> None:
        """Cycle index `i`. With `phase_s`, each phase's host-clock seconds,
        the device synchronised before and after it, are added there; with
        `spans`, each phase opens a host span (it names the idle gaps of a
        trace's breakdown)."""
        phases, self.batch = self._phases(self.gan, self.pool, i, self.batch)
        generator = seeded(self.run.seed, f"window{i}", self.run.device)
        for name, fn in phases:
            if phase_s is not None:
                sync(self.run.device)
                start = time.perf_counter()
                fn(generator)
                sync(self.run.device)
                phase_s[name] = phase_s.get(name, 0.0) + time.perf_counter() - start
            elif spans:
                with torch.profiler.record_function(f"bench.{name}"):
                    fn(generator)
            else:
                fn(generator)
        sync(self.run.device)

    def measure(self) -> dict:
        start = time.perf_counter()
        steps = 0
        while True:
            self._cycle(steps)
            steps += 1
            elapsed = time.perf_counter() - start
            if elapsed >= self.run.seconds:
                break
        self.attempted = steps
        return {"train_s_per_step": elapsed / steps}

    def traced(self) -> dict:
        """The per-layer readings: `trace_steps` cycles from index 0 timed
        by the host clock, untraced (the cycles' seconds and each phase's),
        then the same cycle indices again under the profiler."""
        from long_video_gan_tpu_torch.ops import filtered_lrelu_cuda

        from .. import flops
        from ..trace import profile

        n = self.traffic["trace_steps"]
        phase_s = {}
        start = time.perf_counter()
        for i in range(n):
            self._cycle(i, phase_s)
        host_s = time.perf_counter() - start
        k2_before = filtered_lrelu_cuda.bwd_launches

        def fn():
            for i in range(n):
                self._cycle(i, spans=True)

        tr = profile(fn)
        self.attempted = 2 * n
        k = self.kwargs
        layers = flops.hand_kernel_layers(_reference_gan_modules(k)["G"])
        frames = k["total_batch"] // k["G_grad_accum"] * k["seq_length"]
        per_step = k["G_grad_accum"] * sum(
            flops.bound_s(layer, frames, torch.bfloat16, True) for layer in layers)
        return dict(trace=tr, steps=n, host_s=host_s,
                    flops=sum(self._step_flops(i, flops) for i in range(n)),
                    phase_ms={name: 1e3 * s / n for name, s in phase_s.items()},
                    k2_bound_s=n * per_step, k2_expected=n * k["G_grad_accum"] * len(layers),
                    k2_launches=filtered_lrelu_cuda.bwd_launches - k2_before)

    def _step_flops(self, i: int, flops) -> int:
        """Dense operations of cycle index `i`, counted on the reference
        trainer on the meta device: one micro-batch of each phase (a
        trainer of the micro-batch's size), times the accumulation."""
        k = self.kwargs
        accum = k["G_grad_accum"]
        assert k["D_grad_accum"] == accum
        micro = dict(k, total_batch=k["total_batch"] // accum, G_grad_accum=1, D_grad_accum=1)
        ref = _reference_gan(micro, "meta")
        meta_pool = [_like_meta(b, micro["total_batch"]) for b in self.pool[:3]]
        phases, _ = self._phases(ref, meta_pool, i, 0)
        generator = torch.Generator().manual_seed(0)
        return accum * flops.count_flops(lambda: [fn(generator) for _, fn in phases])

    # -- correctness -------------------------------------------------------------

    def free(self) -> None:
        del self.gan
        release(self.run.device)

    def _reference_cycles(self, lower: bool) -> dict:
        """The reference's checked cycles from the benchmark's weights and
        batches, TF32 off; with `lower`, its float32 operands rounded to
        bfloat16."""
        dev = self.run.device
        with ref_ops.tf32_off(), ref_ops.lower_precision(lower, fp8=False):
            ref = _reference_gan(self.kwargs, dev)
            ref.G.load_state_dict(self.states["G"])
            ref.D.load_state_dict(self.states["D"])
            ref.init_state(None)
            cycles = self._checked_cycles(ref, self.pool)
        del ref
        release(dev)
        return cycles

    def check(self, control: bool) -> dict:
        want = self._reference_cycles(lower=False)
        got = self._reference_cycles(lower=True) if control else self.program
        out = {}
        for phase, short in (("update_G", "G"), ("update_D", "D"), ("update_r1", "r1")):
            gaps = [finite(abs(a - b) / max(abs(b), 1e-12))
                    for a, b in zip(got["losses"][phase], want["losses"][phase])]
            out[f"loss_rel.{short}"] = max(gaps)
            out[f"loss0_rel.{short}"] = gaps[0]
            out[f"grad_norm_rel.{short}"] = _norm_gap(got["grads"][phase], want["grads"][phase])
            out[f"grad_norm_med.{short}"] = _norm_gap(got["grads"][phase], want["grads"][phase],
                                                      reduce=torch.median)
        biggest_D = torch.maximum(want["grads"]["update_D"], want["grads"]["update_r1"])
        keep = {"G": _moved(want["grads"]["update_G"]), "D": _moved(biggest_D)}
        keep["G_ema"] = keep["G"]
        for name in ("G", "D", "G_ema"):
            out[f"change_norm_rel.{name}"] = _norm_gap(got["change"][name],
                                                       want["change"][name], keep[name])
        out["compared"] = sum(len(v) for v in want["losses"].values())
        return out


def _moved(grad_norms: torch.Tensor) -> torch.Tensor:
    """The leaves whose reference gradient is a thousandth of the median
    leaf's or more (the others move under Adam by rounding alone)."""
    return grad_norms >= TINY_GRAD * grad_norms.median()


def _like_meta(batch, rows: int):
    if isinstance(batch, tuple):
        return tuple(_like_meta(b, rows) for b in batch)
    return torch.empty((rows, *batch.shape[1:]), dtype=batch.dtype, device="meta")


def _reference_gan_modules(kwargs: dict) -> dict:
    """The reference G and D on the CPU (shapes and constants for the
    weights)."""
    from ..reference.sres_discriminator import VideoDiscriminator
    from ..reference.sres_generator import VideoGenerator

    k = copy.deepcopy(kwargs)
    k["G_kwargs"].pop("resample_impl", None)
    G = VideoGenerator(hr_height=k["hr_height"], hr_width=k["hr_width"],
                       lr_height=k["lr_height"], lr_width=k["lr_width"],
                       temporal_context=k["temporal_context"], **k["G_kwargs"], device="cpu")
    D = VideoDiscriminator(seq_length=k["seq_length"], lr_height=k["lr_height"],
                           lr_width=k["lr_width"], hr_height=k["hr_height"],
                           hr_width=k["hr_width"], **k["D_kwargs"], device="cpu")
    return {"G": G, "D": D}
