"""Metric registry + entry point (reference: metrics/metric_main.py:30-134).

The port's counterpart of `long_video_gan_tpu/metrics/metric_main.py`: the
same registry, metrics and protocol parameters.

Registered metrics (same seven as the reference):
  fvd2048_16f, fvd2048_128f, fvd2048_128f_subsample8f  (I3D Frechet video distance)
  fid50k_full                                          (InceptionV3 FID, per-video weighted)
  kid50k_full                                          (InceptionV3 KID)
  is50k                                                (InceptionV3 IS)
  isv2048_ucf                                          (C3D video IS)
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np

from .feature_stats import (
    frechet_distance,
    inception_score_from_probs,
    kid_from_features,
)
from .metric_utils import (
    MetricOptions,
    compute_feature_stats_for_dataset,
    compute_feature_stats_for_generator,
)

_metric_dict: dict[str, Callable] = {}


def register_metric(fn: Callable) -> Callable:
    assert fn.__name__ not in _metric_dict
    _metric_dict[fn.__name__] = fn
    return fn


def is_valid_metric(metric: str) -> bool:
    return metric in _metric_dict


def list_valid_metrics() -> list[str]:
    return list(_metric_dict.keys())


def calc_metric(metric: str, num_runs: int = 1, **kwargs) -> dict:
    """Compute a metric `num_runs` times with different seeds and average
    (reference :48-83; video metric variance is high, README.md:126)."""
    assert is_valid_metric(metric), f"unknown metric {metric}; valid: {list_valid_metrics()}"
    start = time.time()
    all_results: dict[str, list] = {}
    for run in range(num_runs):
        opts = MetricOptions(num_runs=num_runs, **kwargs)
        opts.seed = opts.seed + run * 131071
        results = _metric_dict[metric](opts)
        for k, v in results.items():
            all_results.setdefault(k, []).append(v)
    results = {k: float(np.mean(v)) for k, v in all_results.items()}
    return dict(results=results, metric=metric, total_time=time.time() - start,
                num_runs=num_runs)


# ---------------------------------------------------------------------------
# FVD family (reference: metrics/frechet_video_distance.py).


def _compute_fvd(opts: MetricOptions, max_real: int, num_gen: int, num_frames: int,
                 subsample_factor: int = 1, frame_spacing: int = 1) -> float:
    detector = "i3d"
    detector_kwargs = {}
    batch = max(1, 64 // num_frames)

    real = compute_feature_stats_for_dataset(
        opts, detector, detector_kwargs, capture_mean_cov=True, max_items=max_real,
        seq_length=num_frames, frame_spacing=frame_spacing * subsample_factor)
    gen = compute_feature_stats_for_generator(
        opts, detector, detector_kwargs, capture_mean_cov=True, max_items=num_gen,
        seq_length=num_frames, frame_spacing=frame_spacing,
        subsample_factor=subsample_factor, batch_size=batch)

    mu_r, sig_r = real.get_mean_cov()
    mu_g, sig_g = gen.get_mean_cov()
    return frechet_distance(mu_g, sig_g, mu_r, sig_r)


@register_metric
def fvd2048_16f(opts: MetricOptions) -> dict:
    return dict(fvd2048_16f=_compute_fvd(opts, max_real=2048, num_gen=2048, num_frames=16))


@register_metric
def fvd2048_128f(opts: MetricOptions) -> dict:
    return dict(fvd2048_128f=_compute_fvd(opts, max_real=2048, num_gen=2048, num_frames=128))


@register_metric
def fvd2048_128f_subsample8f(opts: MetricOptions) -> dict:
    """128-frame span subsampled by 8 -> 16 detector frames (reference
    metric_main.py:125-128)."""
    return dict(fvd2048_128f_subsample8f=_compute_fvd(
        opts, max_real=2048, num_gen=2048, num_frames=16, subsample_factor=8))


# ---------------------------------------------------------------------------
# Image metrics on per-frame features (InceptionV3; reference
# frechet_inception_distance.py / kernel_inception_distance.py / inception_score.py).


@register_metric
def fid50k_full(opts: MetricOptions) -> dict:
    detector = "inception"
    detector_kwargs = dict(return_features=True)
    real = compute_feature_stats_for_dataset(
        opts, detector, detector_kwargs, capture_mean_cov=True, max_items=None,
        seq_length=1)
    gen = compute_feature_stats_for_generator(
        opts, detector, detector_kwargs, capture_mean_cov=True, max_items=50_000,
        seq_length=1)
    mu_r, sig_r = real.get_mean_cov()
    mu_g, sig_g = gen.get_mean_cov()
    return dict(fid50k_full=frechet_distance(mu_g, sig_g, mu_r, sig_r))


@register_metric
def kid50k_full(opts: MetricOptions) -> dict:
    detector = "inception"
    detector_kwargs = dict(return_features=True)
    real = compute_feature_stats_for_dataset(
        opts, detector, detector_kwargs, capture_all=True, max_items=1_000_000,
        seq_length=1)
    gen = compute_feature_stats_for_generator(
        opts, detector, detector_kwargs, capture_all=True, max_items=50_000,
        seq_length=1)
    kid = kid_from_features(real.get_all(), gen.get_all(), seed=opts.seed)
    return dict(kid50k_full=kid)


@register_metric
def is50k(opts: MetricOptions) -> dict:
    detector = "inception"
    detector_kwargs = dict(no_output_bias=True)
    gen = compute_feature_stats_for_generator(
        opts, detector, dict(detector_kwargs, return_probs=True), capture_all=True,
        max_items=50_000, seq_length=1)
    mean, std = inception_score_from_probs(gen.get_all())
    return dict(is50k_mean=mean, is50k_std=std)


@register_metric
def isv2048_ucf(opts: MetricOptions) -> dict:
    """Video inception score with the C3D UCF-101 detector (reference:
    metrics/video_inception_score.py:24-61)."""
    detector = "c3d"
    gen = compute_feature_stats_for_generator(
        opts, detector, dict(return_probs=True), capture_all=True,
        max_items=2048, seq_length=16)
    mean, std = inception_score_from_probs(gen.get_all())
    return dict(isv2048_ucf_mean=mean, isv2048_ucf_std=std)


def report_metrics(metrics: list[str], run_dir: str, step: int, **kwargs) -> None:
    """The trainers' in-training metrics: each of `metrics` computed with
    `kwargs` (`MetricOptions` fields), printed as a JSON line and appended
    to `<run_dir>/metric-<name>.jsonl` (the JAX trainers' files)."""
    import json
    from pathlib import Path

    for metric in metrics:
        line = json.dumps(dict(calc_metric(metric=metric, **kwargs), step=step))
        print(line)
        with open(Path(run_dir, f"metric-{metric}.jsonl"), "at") as fp:
            fp.write(line + "\n")
