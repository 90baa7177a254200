"""Streaming feature statistics (mean/cov, raw features, weighted variants)
and the distances computed from them.

The port's copy of `long_video_gan_tpu/metrics/feature_stats.py`: the same
numpy code (but for `sqrtm`'s removed `disp` argument), so both packages
compute the same function on the same features, and a stats `.npz` that
either writes loads in the other. It ports the reference's FeatureStats
(metrics/metric_utils.py:93-181), including the per-video weighting used by
fid50k_full (weight = 1 / num_samples_from_source per frame so every source
video contributes equally).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class FeatureStats:
    def __init__(self, capture_all: bool = False, capture_mean_cov: bool = False,
                 max_items: Optional[int] = None):
        self.capture_all = capture_all
        self.capture_mean_cov = capture_mean_cov
        self.max_items = max_items
        self.num_items = 0
        self.num_features: Optional[int] = None
        self.all_features: Optional[list] = None
        self.raw_mean: Optional[np.ndarray] = None
        self.raw_cov: Optional[np.ndarray] = None
        self.total_weight = 0.0

    def set_num_features(self, num_features: int) -> None:
        if self.num_features is not None:
            assert num_features == self.num_features
            return
        self.num_features = num_features
        self.all_features = []
        self.raw_mean = np.zeros([num_features], dtype=np.float64)
        self.raw_cov = np.zeros([num_features, num_features], dtype=np.float64)

    def is_full(self) -> bool:
        return self.max_items is not None and self.num_items >= self.max_items

    def append(self, x: np.ndarray, weights: Optional[np.ndarray] = None) -> None:
        x = np.asarray(x, dtype=np.float32)
        assert x.ndim == 2
        if weights is not None:
            weights = np.asarray(weights, dtype=np.float64).reshape(-1)
            assert weights.shape[0] == x.shape[0]

        if self.max_items is not None:
            if self.num_items >= self.max_items:
                return
            keep = min(x.shape[0], self.max_items - self.num_items)
            if keep < x.shape[0]:
                x = x[:keep]
                weights = weights[:keep] if weights is not None else None

        self.set_num_features(x.shape[1])
        self.num_items += x.shape[0]
        if self.capture_all:
            self.all_features.append(x.copy())
        if self.capture_mean_cov:
            x64 = x.astype(np.float64)
            if weights is None:
                self.raw_mean += x64.sum(axis=0)
                self.raw_cov += x64.T @ x64
                self.total_weight += x.shape[0]
            else:
                self.raw_mean += (x64 * weights[:, None]).sum(axis=0)
                self.raw_cov += (x64 * weights[:, None]).T @ x64
                self.total_weight += weights.sum()

    def get_all(self) -> np.ndarray:
        assert self.capture_all
        return np.concatenate(self.all_features, axis=0) if self.all_features else \
            np.zeros([0, self.num_features or 0], np.float32)

    def get_mean_cov(self) -> tuple[np.ndarray, np.ndarray]:
        assert self.capture_mean_cov and self.total_weight > 0
        mean = self.raw_mean / self.total_weight
        cov = self.raw_cov / self.total_weight - np.outer(mean, mean)
        return mean, cov

    # -- (de)serialization for the stats cache --------------------------------

    def save(self, path: str) -> None:
        import os

        tmp = f"{path}.tmp.{os.getpid()}"
        np.savez(
            tmp,
            num_items=self.num_items,
            num_features=self.num_features if self.num_features is not None else -1,
            capture_all=self.capture_all,
            capture_mean_cov=self.capture_mean_cov,
            max_items=self.max_items if self.max_items is not None else -1,
            raw_mean=self.raw_mean if self.raw_mean is not None else np.zeros(0),
            raw_cov=self.raw_cov if self.raw_cov is not None else np.zeros(0),
            total_weight=self.total_weight,
            all_features=self.get_all() if self.capture_all else np.zeros([0, 0], np.float32),
        )
        os.replace(tmp + ".npz", path)

    @classmethod
    def load(cls, path: str) -> "FeatureStats":
        data = np.load(path, allow_pickle=False)
        max_items = int(data["max_items"])
        obj = cls(capture_all=bool(data["capture_all"]),
                  capture_mean_cov=bool(data["capture_mean_cov"]),
                  max_items=None if max_items < 0 else max_items)
        nf = int(data["num_features"])
        if nf >= 0:
            obj.set_num_features(nf)
            obj.raw_mean = data["raw_mean"]
            obj.raw_cov = data["raw_cov"]
            obj.total_weight = float(data["total_weight"])
            if obj.capture_all and data["all_features"].size:
                obj.all_features = [data["all_features"]]
        obj.num_items = int(data["num_items"])
        return obj


def frechet_distance(mu_a: np.ndarray, sigma_a: np.ndarray,
                     mu_b: np.ndarray, sigma_b: np.ndarray) -> float:
    """Frechet distance between Gaussians (reference:
    metrics/frechet_video_distance.py:56-62 / frechet_inception_distance.py:56-62)."""
    import scipy.linalg

    m = np.square(mu_a - mu_b).sum()
    # Without `disp`, which SciPy 1.18 removed: the same square root as the
    # JAX package's `disp=False` call, without its error estimate.
    s = scipy.linalg.sqrtm(np.dot(sigma_a, sigma_b))
    return float(np.real(m + np.trace(sigma_a + sigma_b - s * 2)))


def kid_from_features(real: np.ndarray, gen: np.ndarray, num_subsets: int = 100,
                      max_subset_size: int = 1000, seed: int = 0) -> float:
    """Polynomial-kernel MMD (reference: metrics/kernel_inception_distance.py:36-46)."""
    n = real.shape[1]
    m = min(min(real.shape[0], gen.shape[0]), max_subset_size)
    rng = np.random.default_rng(seed)
    t = 0.0
    for _ in range(num_subsets):
        x = gen[rng.choice(gen.shape[0], m, replace=False)]
        y = real[rng.choice(real.shape[0], m, replace=False)]
        a = (x @ x.T / n + 1) ** 3 + (y @ y.T / n + 1) ** 3
        b = (x @ y.T / n + 1) ** 3
        t += (a.sum() - np.trace(a)) / (m - 1) - b.sum() * 2 / m
    return float(t / num_subsets / m)


def inception_score_from_probs(probs: np.ndarray, num_splits: int = 10) -> tuple[float, float]:
    """IS = exp(E KL(p(y|x) || p(y))) over splits (reference:
    metrics/inception_score.py:39-45)."""
    scores = []
    for i in range(num_splits):
        part = probs[probs.shape[0] * i // num_splits: probs.shape[0] * (i + 1) // num_splits]
        kl = part * (np.log(part + 1e-10) - np.log(np.mean(part, axis=0, keepdims=True) + 1e-10))
        scores.append(np.exp(np.mean(np.sum(kl, axis=1))))
    return float(np.mean(scores)), float(np.std(scores))
