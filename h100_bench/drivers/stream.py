"""Streaming super-resolution: the `stream` traffic driver.

A closed loop of videos through `long_video_gan_tpu_torch.generate.
super_resolve`, one after another until the window ends, each hr segment
copied to the host with `.cpu()` as the streaming CLI does. The traffic file
gives the sizes; the lr videos are drawn on the card at set-up from the seed
and cycled, with one z per video.

`correct`: once the window has closed and the program is freed, the plain
reference (`h100_bench/reference/sres_generator.py`) recomputes a sample of
the delivered segments, drawn from the seed (one segment index per video), from
the same weights, lr window and z, and the worst relative gaps are compared
with the cell's limits.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import flops
from ..common import Run, draw_state, finite, release, seeded, subseed, sync
from ..reference import ops as ref_ops
from ..reference.sres_generator import VideoGenerator as RefGenerator
from ..reference.sres_generator import segment_window


def _lr_videos(traffic: dict, cfg: dict, seed: int, device) -> torch.Tensor:
    """[videos, 1, 3, lr frames, lh, lw] lr videos, smooth in time: white
    noise blurred over `lr_blur` frames, scaled to `lr_std`, clamped to
    [-1, 1]."""
    g = seeded(seed, "lr", device)
    frames = traffic["frames_per_video"] + 2 * cfg["temporal_context"]
    k = traffic["lr_blur"]
    shape = (traffic["lr_videos"], 3, frames + k - 1, cfg["lr_height"], cfg["lr_width"])
    noise = torch.randn(shape, generator=g, device=device)
    video = noise.unfold(2, k, 1).mean(-1) * (traffic["lr_std"] * k ** 0.5)
    return video.clamp(-1, 1).unsqueeze(1).contiguous()


class Driver:
    def __init__(self, run: Run):
        self.run = run
        cfg, traffic = run.config["model"], run.traffic
        self.cfg, self.traffic = cfg, traffic
        self.segment = traffic["segment_length"]
        self.frames = traffic["frames_per_video"]
        self.segments_per_video = self.frames // self.segment
        self.psi = traffic["truncation_psi"]
        self.spans = False   # host spans, in the traced window only

    # -- set-up ----------------------------------------------------------------

    def setup(self) -> None:
        from long_video_gan_tpu_torch.models.generator_sres import VideoGenerator

        run, dev = self.run, self.run.device
        ref = RefGenerator(**self.cfg, device="cpu")
        self.G = VideoGenerator(**self.cfg, resample_impl=self.run.config["resample_impl"],
                                device=dev)
        self.G.load_state_dict(draw_state(ref, run.seed, dev))
        self.G.eval().requires_grad_(False)
        del ref
        self.lr = _lr_videos(self.traffic, self.cfg, run.seed, dev)
        self.z = torch.randn((self.traffic["z_table"], self.cfg["latent_z_dim"]),
                             generator=seeded(run.seed, "z", dev), device=dev)
        rng = np.random.default_rng(subseed(run.seed, "sample"))
        self.sample_index = rng.integers(0, self.segments_per_video, self.traffic["z_table"])
        # Every segment has the same shapes: warm them on a few.
        for s, _, _ in self._video(self.traffic["z_table"] - 1):
            if s + 1 >= self.traffic["warm_segments"]:
                break
        sync(dev)

    def _video(self, v: int):
        """Yield (segment index, host segment, arrival time) of video `v`."""
        from long_video_gan_tpu_torch.generate import super_resolve

        lr = self.lr[v % self.lr.shape[0]]
        z = self.z[v % self.z.shape[0]][None]
        stream = super_resolve(self.G, lr, self.frames, segment_length=self.segment,
                               truncation_psi=self.psi, prefetch=self.traffic["prefetch"],
                               generator=None, z=z)
        for s, seg in enumerate(stream):
            if self.spans:
                with torch.profiler.record_function("bench.segment_to_host"):
                    host = seg.cpu()
            else:
                host = seg.cpu()
            yield s, self.run.alter(host), time.perf_counter()

    # -- the window ------------------------------------------------------------

    def window(self, seconds: float, max_segments: int | None = None) -> dict:
        """Videos one after another until `seconds` have passed (or
        `max_segments` segments came); the kept sample of segments."""
        latencies, kept = [], {}
        start = last = time.perf_counter()
        frames = v = 0
        done = False
        while not done:
            video_start = time.perf_counter()
            prev = video_start
            for s, host, arrived in self._video(v):
                latencies.append(arrived - prev)
                prev = last = arrived
                frames += host.shape[0] * host.shape[2]
                if s == self.sample_index[v % len(self.sample_index)]:
                    kept[(v, s)] = host
                if (arrived - start >= seconds
                        or (max_segments is not None and len(latencies) >= max_segments)):
                    done = True
                    break
            v += 1
        window_s = last - start
        sync(self.run.device)
        return dict(window_s=window_s, frames=frames, latencies=latencies, kept=kept,
                    segments=len(latencies))

    def measure(self) -> dict:
        out = self.window(self.run.seconds)
        lat_ms = np.asarray(out["latencies"]) * 1e3
        self.kept = out["kept"]
        self.attempted = out["segments"]
        return {"gen_frames_per_s": out["frames"] / out["window_s"],
                "segment_ms_p95": float(np.percentile(lat_ms, 95))}

    def traced(self) -> dict:
        """The per-layer readings: a window of `trace_segments` timed by the
        host clock, untraced, then one as long under the profiler."""
        from long_video_gan_tpu_torch.ops import filtered_lrelu_cuda

        from ..trace import profile

        n = self.traffic["trace_segments"]
        timed = self.window(float("inf"), max_segments=n)
        box = {}
        k1_before = filtered_lrelu_cuda.launches

        def fn():
            self.spans = True
            box.update(self.window(float("inf"), max_segments=n))
            self.spans = False

        tr = profile(fn)
        self.kept = box["kept"]
        self.attempted = timed["segments"] + box["segments"]
        ref = RefGenerator(**self.cfg, device="cpu")
        layers = flops.hand_kernel_layers(ref)
        k1 = filtered_lrelu_cuda.launches - k1_before
        segs = box["segments"]
        return dict(trace=tr, frames=timed["frames"], host_s=timed["window_s"],
                    flops=timed["frames"] * flops.flops_per_frame(ref, self.segment),
                    k1_launches=k1, k1_expected=segs * len(layers),
                    k1_bound_s=segs * sum(flops.bound_s(layer, self.segment, torch.bfloat16,
                                                        False) for layer in layers))

    # -- correctness -------------------------------------------------------------

    def free(self) -> None:
        del self.G
        release(self.run.device)

    def check(self, control: bool) -> dict[str, float]:
        """Worst relative RMS and max-abs gap of the kept segments against the
        reference (in control: the reference in lower precision in the
        program's place)."""
        dev = self.run.device
        ref = RefGenerator(**self.cfg, device=dev)
        ref.load_state_dict(draw_state(RefGenerator(**self.cfg, device="cpu"), self.run.seed,
                                       dev))
        ref.eval().requires_grad_(False)
        rms = mx = 0.0
        with torch.no_grad(), ref_ops.tf32_off():
            for (v, s), got in sorted(self.kept.items()):
                lr = segment_window(self.lr[v % self.lr.shape[0]], s, self.segment,
                                    self.cfg["temporal_context"])
                z = self.z[v % self.z.shape[0]][None]
                want = ref(lr, z, truncation_psi=self.psi).cpu()
                if control:
                    with ref_ops.lower_precision():
                        got = ref(lr, z, truncation_psi=self.psi).cpu()
                err = (got.float() - want).abs()
                rms = max(rms, finite(float(err.square().mean().sqrt()
                                            / want.square().mean().sqrt())))
                mx = max(mx, finite(float(err.max() / want.abs().max())))
        return {"segment_rel_rms": rms, "segment_rel_max": mx, "compared": len(self.kept)}
