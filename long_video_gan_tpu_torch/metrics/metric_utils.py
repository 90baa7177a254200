"""Metric plumbing: options, cached dataset statistics, generator sampling.

Counterpart of `long_video_gan_tpu/metrics/metric_utils.py` (itself the
reference's metrics/metric_utils.py): feature extraction streams batches
through a detector (see detectors.py), dataset-side statistics are cached
on disk under a blake2b hash of their configuration (reference :248-277),
and the generator side reproduces the three sampling protocols, including
the random temporal offsets (reference :334-442).

The dataset side draws its order and clips from
`np.random.default_rng(opts.seed)`, as the JAX package does, so the same
detector gives the same dataset statistics in both. The generator side draws
the lres noise, the temporal offsets and z from one torch generator seeded
from `opts.seed` (`GeneratorDraws`); JAX's threefry keys draw other numbers,
so generated statistics agree with the JAX package's in distribution, not
sample by sample. Videos become uint8 on the host, in numpy, as in the JAX
package, so that the same video gives the same bytes.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Iterator, Optional, Union

import numpy as np
import torch
from torch import nn

from .detectors import get_detector
from .feature_stats import FeatureStats


@dataclass
class MetricOptions:
    """Everything a metric computation needs (reference :29-46).

    `G` / `lr_G` are generator modules on the device they run on;
    `dataset_kwargs` configure `data.dataset` classes; the detectors run on
    `device`. `detector` overrides the default detector spec (tests pass
    "stub:<dim>").
    """

    G: Optional[nn.Module] = None
    lr_G: Optional[nn.Module] = None
    dataset_kwargs: dict = field(default_factory=dict)
    cond_dataset_kwargs: dict = field(default_factory=dict)
    num_runs: int = 1
    batch_size: int = 16
    normalize_weighting: bool = True
    single_sample_per_video: bool = False
    replace_cache: bool = False
    verbose: bool = False
    cache_dir: Optional[str] = None
    detector: Optional[str] = None
    seed: int = 0
    # Test/CI knob: caps feature counts of every metric (e.g. 64 for smoke).
    max_items_override: Optional[int] = None
    device: Union[str, torch.device] = "cuda"

    def cache_path(self, tag: str, **key_kwargs) -> str:
        """The port's own cache directory by default, apart from the JAX
        package's: its detectors round differently, so their statistics
        must not serve the port's runs."""
        cache_dir = self.cache_dir or os.path.join(
            os.environ.get("LVG_CACHE_DIR", os.path.expanduser("~/.cache")),
            "long_video_gan_tpu_torch", "metric_stats")
        args = json.dumps(dict(tag=tag, **key_kwargs), sort_keys=True, default=str)
        digest = hashlib.blake2b(args.encode("utf-8"), digest_size=16).hexdigest()
        return os.path.join(cache_dir, f"{tag}-{digest}.npz")


def _to_uint8(video: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(video) * 127.5 + 128, 0, 255).astype(np.uint8)


def _cap(opts: MetricOptions, max_items: Optional[int]) -> Optional[int]:
    if opts.max_items_override is not None:
        return min(max_items or opts.max_items_override, opts.max_items_override)
    return max_items


# ---------------------------------------------------------------------------


def compute_feature_stats_for_dataset(
    opts: MetricOptions,
    detector_spec: str,
    detector_kwargs: Optional[dict] = None,
    capture_all: bool = False,
    capture_mean_cov: bool = False,
    max_items: Optional[int] = None,
    seq_length: Optional[int] = None,
    frame_spacing: int = 1,
    dataset_kwargs_override: Optional[dict] = None,
) -> FeatureStats:
    """Stream real data through the detector (reference :230-330), with the
    per-video weighting for image metrics and a disk cache keyed on the
    detector that runs (`opts.detector` where set), so that statistics of
    one detector never serve another."""
    from ..data.dataset import VideoDataset, VideoDatasetPerImage

    max_items = _cap(opts, max_items)
    dataset_kwargs = dict(opts.dataset_kwargs)
    dataset_kwargs.update(dataset_kwargs_override or {})
    if seq_length is not None:
        dataset_kwargs["seq_length"] = seq_length

    spec = opts.detector or detector_spec
    cache_path = opts.cache_path(
        "dataset-stats", detector=spec, detector_kwargs=detector_kwargs,
        dataset=dataset_kwargs, capture_all=capture_all, capture_mean_cov=capture_mean_cov,
        max_items=max_items, spacing=frame_spacing,
        weighting=opts.normalize_weighting, single=opts.single_sample_per_video)
    if os.path.isfile(cache_path) and not opts.replace_cache:
        return FeatureStats.load(cache_path)

    detector = get_detector(spec, opts.device)
    detector_kwargs = detector_kwargs or {}
    stats = FeatureStats(capture_all=capture_all, capture_mean_cov=capture_mean_cov,
                         max_items=max_items)
    rng = np.random.default_rng(opts.seed)

    video_metric = dataset_kwargs.get("seq_length", 1) > 1
    if video_metric:
        ds = VideoDataset(min_spacing=frame_spacing, max_spacing=frame_spacing,
                          **dataset_kwargs)
    else:
        ds = VideoDatasetPerImage(**dataset_kwargs)

    order = rng.permutation(len(ds))
    idx = 0
    while not stats.is_full() and idx < len(order):
        batch_videos, batch_weights = [], []
        while len(batch_videos) < opts.batch_size and idx < len(order):
            item = ds.sample(int(order[idx]), rng)
            batch_videos.append(item["video"])
            if "num_samples_from_source" in item and opts.normalize_weighting:
                batch_weights.append(1.0 / item["num_samples_from_source"])
            idx += 1
        videos = _to_uint8(np.stack(batch_videos))                  # [N, C, T, H, W]
        if video_metric:
            feats = detector(videos, **detector_kwargs)
        else:
            feats = detector(videos[:, :, 0], **detector_kwargs)    # [N, C, H, W]
        weights = np.asarray(batch_weights) if batch_weights else None
        stats.append(feats, weights=weights)
        if opts.verbose:
            print(f"  dataset features: {stats.num_items}")

    os.makedirs(os.path.dirname(cache_path), exist_ok=True)
    stats.save(cache_path)
    return stats


# ---------------------------------------------------------------------------


class GeneratorDraws:
    """Every random draw of the generator side: the lres noise, the temporal
    offsets and z, in that order per batch, from one torch generator on the
    CPU seeded from `seed` (so a seed draws the same numbers whatever device
    the generators run on). Tests replace it to inject the draws."""

    def __init__(self, seed: int):
        self.generator = torch.Generator().manual_seed(seed)

    def noise(self, shape: tuple[int, ...]) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator)

    def offset(self, high: int) -> int:
        """A temporal offset in [0, high)."""
        return int(torch.randint(high, (), generator=self.generator))

    def z(self, batch: int, dim: int) -> torch.Tensor:
        return torch.randn((batch, dim), generator=self.generator)


def _device_of(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


@torch.inference_mode()
def generator_batches(opts: MetricOptions, gen_len: int, batch: int, video_metric: bool,
                      draws: GeneratorDraws) -> Iterator[tuple[torch.Tensor, Optional[np.ndarray]]]:
    """Yield (video [N, 3, gen_len, H, W] on the generator's device, per-item
    weights or None) batches of the sampling protocol that `opts` selects
    (reference :334-442):

      * two-stage lres -> sres (`opts.lr_G` set): the lres G makes
        gen_len + 2*context + total_temporal_scale frames, a random temporal
        offset crops away the extra frames so statistics are
        offset-invariant (reference :399-408), then the sres G
        super-resolves the whole window in one pass;
      * the sres G conditioned on real lr clips from
        `opts.cond_dataset_kwargs` (in-training sres metrics, reference
        :351-358,409-423): image metrics (not `video_metric`) draw per-frame
        windows without replacement, weighting each video equally, and stop
        when the dataset is exhausted; video metrics sample clips with
        replacement;
      * the single-stage lres G otherwise.
    """
    G = opts.G
    device = _device_of(G)
    if opts.lr_G is not None:
        lr_G = opts.lr_G
        context = G.temporal_context
        extra = lr_G.total_temporal_scale
        lr_len = gen_len + 2 * context + extra
        while True:
            lr = lr_G(batch, lr_len, noise=draws.noise(lr_G.noise_shape(batch, lr_len))
                      .to(_device_of(lr_G)))
            off = draws.offset(extra + 1)
            lr = lr[:, :, off:off + gen_len + 2 * context].to(device)
            yield G(lr, z=draws.z(batch, G.latent_z_dim).to(device)), None
    elif opts.cond_dataset_kwargs:
        from ..data.dataset import VideoDataset, VideoDatasetPerImage

        rng = np.random.default_rng(opts.seed + 1)
        cond_kwargs = dict(opts.cond_dataset_kwargs)
        cond_kwargs["seq_length"] = gen_len + 2 * G.temporal_context
        ds = VideoDataset(**cond_kwargs) if video_metric else VideoDatasetPerImage(**cond_kwargs)
        order = rng.permutation(len(ds))
        cursor = 0
        while video_metric or cursor < len(order):
            items = []
            while len(items) < batch and (video_metric or cursor < len(order)):
                items.append(ds.sample(int(order[cursor % len(order)]), rng))
                cursor += 1
            lr = torch.from_numpy(np.stack([it["video"] for it in items])).to(device)
            weights = None
            if not video_metric and opts.normalize_weighting and \
                    "num_samples_from_source" in items[0]:
                weights = np.asarray([1.0 / it["num_samples_from_source"] for it in items])
            yield G(lr, z=draws.z(len(items), G.latent_z_dim).to(device)), weights
    else:
        extra = G.total_temporal_scale
        lr_len = gen_len + extra
        while True:
            video = G(batch, lr_len, noise=draws.noise(G.noise_shape(batch, lr_len)).to(device))
            off = draws.offset(extra + 1)
            yield video[:, :, off:off + gen_len], None


def compute_feature_stats_for_generator(
    opts: MetricOptions,
    detector_spec: str,
    detector_kwargs: Optional[dict] = None,
    capture_all: bool = False,
    capture_mean_cov: bool = False,
    max_items: Optional[int] = None,
    seq_length: int = 1,
    frame_spacing: int = 1,
    subsample_factor: int = 1,
    batch_size: Optional[int] = None,
    draws: Optional[GeneratorDraws] = None,
) -> FeatureStats:
    """Sample the generator pipeline (`generator_batches`; draws from
    `GeneratorDraws(opts.seed)` unless given) and stream the features of
    every `frame_spacing * subsample_factor`-th frame, `seq_length` of them
    per video (reference :334-442)."""
    max_items = _cap(opts, max_items)
    detector = get_detector(opts.detector or detector_spec, opts.device)
    detector_kwargs = detector_kwargs or {}
    stats = FeatureStats(capture_all=capture_all, capture_mean_cov=capture_mean_cov,
                         max_items=max_items)
    gen_len = seq_length * frame_spacing * subsample_factor
    batch = batch_size or max(1, 64 // max(gen_len, 1))
    batches = generator_batches(opts, gen_len, batch, seq_length > 1,
                                draws or GeneratorDraws(opts.seed))
    while not stats.is_full():
        video, weights = next(batches, (None, None))
        if video is None:  # finite cond dataset exhausted (image metrics)
            break
        step = frame_spacing * subsample_factor
        videos = _to_uint8(video[:, :, ::step][:, :, :seq_length].float().cpu().numpy())
        if seq_length > 1:
            feats = detector(videos, **detector_kwargs)
        else:
            feats = detector(videos[:, :, 0], **detector_kwargs)
        stats.append(feats, weights=weights)
        if opts.verbose:
            print(f"  generator features: {stats.num_items}")
    return stats
