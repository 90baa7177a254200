"""Lres training cycles: the `train_lres` traffic driver.

It drives the program's lres trainer CLI by its own functions
(`long_video_gan_tpu_torch.train_lres`): `build_config` at the
configuration's preset, total batch, gradient accumulation and R1 gamma,
`make_gan`, `gan.init_state`, and `train_step` for every cycle (update_G,
update_D, update_r1 where i % r1_interval == 0, update_G_ema), after
`utils.misc.set_matmul_precision` at the configuration's precision, as
`--matmul-precision` sets it. The configuration file holds what
`build_config` gives (`gan`, `cadence`), and set-up refuses to run if they
differ. The weights are the benchmark's, drawn from the seed, and the real
clips a pool of `pool_batches` batches drawn on the card; each cycle index i
draws from a generator seeded from (seed, i). Set-up runs the first
`checked_steps` cycles; the window starts at index 0 again, so it holds an
R1 step, and times whole cycles for `--seconds`. Every cycle ends in
`torch.cuda.synchronize()`.

`correct`: the plain reference (`h100_bench/reference/gan_lres.py`, float32
with TF32 off) follows the checked cycles from the same weights, batches and
random draws, and the numbers of `drivers/train.py`'s check are compared:
per-phase losses, cycle-0 gradient norms, per-module change norms. The
control puts the reference with TF32 on (cuDNN's and the matrix products')
in the program's place.

A traced run times `trace_steps` cycles from index 0 on the host clock
(each phase with the device synchronised around it), then runs them again
under the profiler and reads its chrome trace twice, as device events
(`trace.read_chrome_trace`) and as the program's spans
(`spans.read_spans`), before deleting it.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import tempfile
import time

import torch

from ..common import Run, draw_state, release, seeded, sync
from ..reference import ops as ref_ops
from . import train as train_driver
from .train import LOSS_KEYS, _norms

GAN_KEYS = ("seq_length", "height", "width", "total_batch")
PHASE_NAMES = ("update_G", "update_D", "update_r1", "update_G_ema")


def cli_config(config: dict) -> dict:
    """`train_lres.build_config` at the configuration's settings."""
    from long_video_gan_tpu_torch.train_lres import build_config

    return build_config("", config["total_batch"], config["grad_accum"], config["r1_gamma"],
                        config["preset"])


def gan_kwargs(c: dict) -> dict:
    """The trainer's keyword arguments that `train_lres.make_gan` passes."""
    return {**{k: c[k] for k in GAN_KEYS}, **c["gan_kwargs"]}


def reference_modules(gan: dict) -> dict:
    """The reference G and D on the CPU (shapes and constants for the
    weights)."""
    from ..reference.lres_discriminator import VideoDiscriminator
    from ..reference.lres_generator import VideoGenerator

    G_kwargs = {k: v for k, v in gan["G_kwargs"].items() if k != "block_remat"}
    return {"G": VideoGenerator(out_height=gan["height"], out_width=gan["width"], **G_kwargs),
            "D": VideoDiscriminator(gan["seq_length"], max(gan["height"], gan["width"]),
                                    **gan["D_kwargs"])}


@contextlib.contextmanager
def tf32_on():
    """TF32 in cuDNN's convolutions and in the matrix products (precision
    "high") inside the block: the control's precision."""
    flags = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = flags[0]
        torch.set_float32_matmul_precision(flags[1])


def conv_calls() -> dict:
    """The program's `ops.conv` call counters (empty where it has none)."""
    from long_video_gan_tpu_torch.ops import conv

    names = ("fwd_calls", "input_grad_calls", "weight_grad_calls")
    return {n: getattr(conv, n) for n in names if hasattr(conv, n)}


@contextlib.contextmanager
def phases_wrapped(gan, wrap):
    """Each phase method of `gan` replaced, on the instance, by
    `wrap(name, method)` inside the block: `train_step` calls them so."""
    for name in PHASE_NAMES:
        setattr(gan, name, wrap(name, getattr(gan, name)))
    try:
        yield
    finally:
        for name in PHASE_NAMES:
            delattr(gan, name)


class Driver:
    def __init__(self, run: Run):
        self.run = run
        self.config = run.config
        self.kwargs = run.config["gan"]
        self.traffic = run.traffic
        self.checked = self.traffic["checked_steps"]

    # -- data ------------------------------------------------------------------

    def _pool(self) -> list:
        """`pool_batches` distinct batches of real clips on the card,
        N(0, 0.5^2) clamped to [-1, 1]."""
        k, dev = self.kwargs, self.run.device
        g = seeded(self.run.seed, "data", dev)
        shape = (k["total_batch"], 3, k["seq_length"], k["height"], k["width"])
        return [torch.randn(shape, generator=g, device=dev).mul_(0.5).clamp_(-1, 1)
                for _ in range(self.traffic["pool_batches"])]

    def _batches(self):
        """The pool in order, round and round: D's batch, then R1's where it
        runs."""
        return itertools.cycle(self.pool)

    # -- one cycle, on the program or the reference ----------------------------

    def _program_step(self, gan, generator, i: int, batches) -> None:
        from long_video_gan_tpu_torch.train_lres import train_step

        train_step(gan, generator, self.c, i, batches)

    def _reference_step(self, gan, generator, i: int, batches) -> None:
        gan.update_G(generator)
        gan.update_D(generator, next(batches))
        if i % self.c["r1_interval"] == 0:
            gan.update_r1(generator, next(batches), gain=float(self.c["r1_interval"]))
        gan.update_G_ema()

    def _checked_cycles(self, gan, step) -> dict:
        """The first `checked` cycles by `step`; each phase's loss, the
        cycle-0 gradient norms per leaf (Adam's first moment after the
        phase) and the change norms per leaf."""
        start = {name: [p.detach().clone() for p in getattr(gan, name).parameters()]
                 for name in ("G", "D", "G_ema")}
        losses, grads = {phase: [] for phase in LOSS_KEYS}, {}
        cycle = [0]

        def wrap(name, method):
            def observed(*args, **kwargs):
                stats = method(*args, **kwargs)
                if name in LOSS_KEYS:
                    m = stats[LOSS_KEYS[name]]
                    losses[name].append(float(m[1] / m[0]))
                    if cycle[0] == 0:
                        opt = gan.opt_G if name == "update_G" else gan.opt_D
                        grads[name] = _norms(opt.mu).cpu()
                return stats
            return observed

        batches = self._batches()
        with phases_wrapped(gan, wrap):
            for i in range(self.checked):
                cycle[0] = i
                step(gan, seeded(self.run.seed, f"cycle{i}", self.run.device), i, batches)
        sync(self.run.device)
        change = {name: _norms([p.detach() - p0 for p, p0 in
                                zip(getattr(gan, name).parameters(), start[name])]).cpu()
                  for name in start}
        return {"losses": losses, "grads": grads, "change": change}

    # -- set-up ----------------------------------------------------------------

    def setup(self) -> None:
        from long_video_gan_tpu_torch.train_lres import make_gan
        from long_video_gan_tpu_torch.utils.misc import set_matmul_precision

        dev = self.run.device
        self.c = cli_config(self.config)
        if gan_kwargs(self.c) != self.kwargs or self.c["r1_interval"] != (
                self.config["cadence"]["r1_interval"]):
            raise ValueError("the configuration's gan and cadence are not train_lres's "
                             f"{self.config['preset']} preset: {gan_kwargs(self.c)}")
        set_matmul_precision(self.config["matmul_precision"])
        self.states = {name: draw_state(module, self.run.seed, dev, f"weights.{name}")
                       for name, module in reference_modules(self.kwargs).items()}
        self.gan = gan = make_gan(self.c, dev)
        gan.G.load_state_dict(self.states["G"])
        gan.D.load_state_dict(self.states["D"])
        gan.init_state(None)
        self.pool = self._pool()
        self.program = self._checked_cycles(gan, self._program_step)

    # -- the window ------------------------------------------------------------

    def _cycles(self, n: int | None = None, seconds: float = float("inf")) -> tuple[int, float]:
        """Cycles from index 0, each from its own generator, until `n` have
        run or `seconds` have passed; (cycles, seconds)."""
        batches = self._batches()
        start = time.perf_counter()
        i = 0
        while True:
            self._program_step(self.gan, seeded(self.run.seed, f"window{i}", self.run.device),
                               i, batches)
            sync(self.run.device)
            i += 1
            elapsed = time.perf_counter() - start
            if i == n or (n is None and elapsed >= seconds):
                return i, elapsed

    def measure(self) -> dict:
        steps, elapsed = self._cycles(seconds=self.run.seconds)
        self.attempted = steps
        return {"train_s_per_step": elapsed / steps}

    def traced(self) -> dict:
        """The per-layer readings: `trace_steps` cycles from index 0 on the
        host clock (each phase's seconds with the device synchronised around
        it), then the same cycle indices under the profiler."""
        from torch.profiler import ProfilerActivity, profile

        from .. import spans
        from ..trace import read_chrome_trace

        n = self.traffic["trace_steps"]
        phase_s, r1_calls = {}, {}

        def timed(name, method):
            def run(*args, **kwargs):
                sync(self.run.device)
                start = time.perf_counter()
                out = method(*args, **kwargs)
                sync(self.run.device)
                phase_s[name] = phase_s.get(name, 0.0) + time.perf_counter() - start
                return out
            return run

        def spanned(name, method):
            def run(*args, **kwargs):
                before = conv_calls()
                with torch.profiler.record_function(f"bench.{name}"):
                    out = method(*args, **kwargs)
                if name == "update_r1":
                    for k, v in conv_calls().items():
                        r1_calls[k] = r1_calls.get(k, 0) + v - before[k]
                return out
            return run

        with phases_wrapped(self.gan, timed):
            _, host_s = self._cycles(n)
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                               if self.run.device.type == "cuda" else [])
        with phases_wrapped(self.gan, spanned), profile(activities=activities) as prof:
            _, window_s = self._cycles(n)
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench-trace-")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            tr = read_chrome_trace(path, window_s)
            st = spans.read_spans(path)
        finally:
            os.remove(path)
        self.attempted = 2 * n
        k = self.kwargs
        return dict(trace=tr, spans=st, steps=n, host_s=host_s,
                    flops=sum(self._step_flops(i) for i in range(n)),
                    phase_ms={name: 1e3 * s / n for name, s in phase_s.items()},
                    r1_conv_calls=r1_calls,
                    G_forwards=n * (k["G_grad_accum"] + k["D_grad_accum"]),
                    G_backwards=n * k["G_grad_accum"])

    def _step_flops(self, i: int) -> int:
        """Dense operations of cycle index `i`, counted on the reference
        trainer on the meta device: one micro-batch of each phase (a trainer
        of the micro-batch's size), times the accumulation."""
        from .. import flops
        from ..reference.gan_lres import LowResVideoGAN

        k = self.kwargs
        accum = k["G_grad_accum"]
        assert k["D_grad_accum"] == accum
        ref = LowResVideoGAN(**dict(k, total_batch=k["total_batch"] // accum, G_grad_accum=1,
                                    D_grad_accum=1), device="meta")
        real = torch.empty((ref.total_batch, *self.pool[0].shape[1:]), device="meta")
        generator = torch.Generator().manual_seed(0)
        return accum * flops.count_flops(
            lambda: self._reference_step(ref, generator, i, itertools.repeat(real)))

    # -- correctness -------------------------------------------------------------

    def free(self) -> None:
        del self.gan
        release(self.run.device)

    def _reference_cycles(self, lower: bool) -> dict:
        """The reference's checked cycles from the benchmark's weights and
        batches, TF32 off; with `lower`, TF32 on."""
        from ..reference.gan_lres import LowResVideoGAN

        dev = self.run.device
        with tf32_on() if lower else ref_ops.tf32_off():
            ref = LowResVideoGAN(**self.kwargs, device=dev)
            ref.G.load_state_dict(self.states["G"])
            ref.D.load_state_dict(self.states["D"])
            ref.init_state(None)
            cycles = self._checked_cycles(ref, self._reference_step)
        del ref
        release(dev)
        return cycles

    # The sres driver's comparison, over these cycles.
    check = train_driver.Driver.check


def layer_ms(ctx: dict, names: list[str]) -> float | None:
    """Device milliseconds per cycle under the program's spans `names` and
    their `.bwd`; nothing unless each opened once per G call (forward) and
    once per G micro-batch of update_G (`.bwd`) in the traced cycles."""
    st = ctx.get("spans")
    if st is None:
        return None
    wanted = set(names)
    forward = sum(1 for s in st.spans if s.name in wanted)
    backward = sum(1 for s in st.spans if s.name.endswith(".bwd") and s.name[:-4] in wanted)
    if (forward, backward) != (len(names) * ctx["G_forwards"], len(names) * ctx["G_backwards"]):
        return None
    seconds = st.seconds(lambda owners: any(
        n in wanted or (n.endswith(".bwd") and n[:-4] in wanted) for n in owners))
    return 1e3 * seconds / ctx["steps"] if seconds > 0 else None
