"""Feature detectors for the quality metrics, and how a detector spec
resolves to one.

Counterpart of `long_video_gan_tpu/metrics/detectors.py`, with the same spec
grammar. The reference downloads pretrained detector networks at metric time
(metrics/metric_utils.py:55-78):
  * FVD:  I3D Kinetics-400 torchscript
    (https://www.dropbox.com/s/ge9e5ujwgetktms/i3d_torchscript.pt)
  * FID/KID/IS: InceptionV3 pickle
    (https://api.ngc.nvidia.com/v2/models/nvidia/research/stylegan3/versions/1/files/metrics/inception-2015-12-05.pkl)
  * video IS: C3D UCF-101 torchscript
    (https://www.dropbox.com/s/jxpu7avzdc9n97q/c3d_ucf.pt)

None ships with the repository and nothing is downloaded: detectors load from
local files. A published file converts into the port's own network
(`i3d.py`, `inception_v3.py`, `c3d.py`) on the caller's device; any other
file runs as a black-box torchscript module there; `stub:<dim>` is a
deterministic random-projection detector for tests and plumbing runs.
The detector interface is: uint8 numpy batch -> float feature matrix
([N, C, T, H, W] for video detectors, [N, C, H, W] for image detectors).
"""

from __future__ import annotations

import functools
import os
from typing import Callable, Union

import numpy as np
import torch

DETECTOR_URLS = {
    "i3d": "https://www.dropbox.com/s/ge9e5ujwgetktms/i3d_torchscript.pt?dl=1",
    "inception": "https://api.ngc.nvidia.com/v2/models/nvidia/research/stylegan3/"
                 "versions/1/files/metrics/inception-2015-12-05.pkl",
    "c3d": "https://www.dropbox.com/s/jxpu7avzdc9n97q/c3d_ucf.pt?dl=1",
}

# Default search location: $LVG_DETECTOR_DIR/<name>.pt
DETECTOR_DIR_ENV = "LVG_DETECTOR_DIR"


class StubDetector:
    """Deterministic random-projection detector for tests: average-pools the
    input and projects to `dim` features (plus softmax for IS-style metrics).
    The JAX package's numpy code, so both give the same features."""

    def __init__(self, dim: int = 64, seed: int = 0):
        self.dim = dim
        self.seed = seed
        self._proj: dict[int, np.ndarray] = {}

    def __call__(self, batch: np.ndarray, return_probs: bool = False, **_) -> np.ndarray:
        batch = np.asarray(batch, dtype=np.float32) / 255.0
        flat = batch.reshape(batch.shape[0], batch.shape[1], -1)
        # Fixed-size signature: channel means + a few moments, projected.
        sig = np.concatenate([
            flat.mean(axis=2), flat.std(axis=2),
            np.abs(flat).mean(axis=2), (flat ** 2).mean(axis=2),
        ], axis=1)
        key = sig.shape[1]
        if key not in self._proj:
            rng = np.random.default_rng(self.seed + key)
            self._proj[key] = rng.standard_normal((key, self.dim)).astype(np.float32)
        feats = sig @ self._proj[key]
        if return_probs:
            e = np.exp(feats - feats.max(axis=1, keepdims=True))
            return e / e.sum(axis=1, keepdims=True)
        return feats


class TorchscriptDetector:
    """Black-box torchscript detector on `device` (the contract of the
    reference's jit-loaded detectors, metrics/metric_utils.py:310-315)."""

    def __init__(self, path: str, device: Union[str, torch.device],
                 forward_kwargs: dict | None = None):
        self.device = torch.device(device)
        self.module = torch.jit.load(path, map_location=self.device).eval()
        self.forward_kwargs = forward_kwargs or {}

    def __call__(self, batch: np.ndarray, **kwargs) -> np.ndarray:
        kw = dict(self.forward_kwargs)
        kw.update(kwargs)
        kw.pop("return_probs", None)
        with torch.no_grad():
            out = self.module(torch.from_numpy(np.ascontiguousarray(batch)).to(self.device), **kw)
        return out.cpu().numpy()


# Exact basenames of the reference's published detector files, mapped to the
# native conversion family. Substring matching is deliberately NOT used: a
# user file named e.g. "c3d_from_i3d_rig.pt" must never be converted as I3D.
_KNOWN_BASENAMES = {
    "i3d.pt": "i3d",
    "i3d_torchscript.pt": "i3d",
    "inception.pkl": "inception",
    "inception.pt": "inception",
    "inception-2015-12-05.pkl": "inception",
    "c3d.pt": "c3d",
    "c3d_ucf.pt": "c3d",
}

_DEFAULT_FILENAMES = {"i3d": "i3d.pt", "inception": "inception.pkl", "c3d": "c3d.pt"}


def _native_or_fallback(family: str, path: str, device: torch.device) -> Callable:
    """Convert `path` into the named family's network on `device`; a
    black-box torchscript module where conversion fails. Prints which."""
    fallback_kwargs = {
        "i3d": dict(rescale=True, resize=True, return_features=True),
        "inception": dict(return_features=True),
        "c3d": {},
    }[family]
    try:
        if family == "i3d":
            from .i3d import I3DDetector as cls
        elif family == "inception":
            from .inception_v3 import InceptionDetector as cls
        else:
            from .c3d import C3DDetector as cls
        det = cls.from_torchscript(path, device)
        print(f"detector {path}: native {family} on {device} (converted weights)")
        return det
    except Exception as e:  # unexpected export layout: black-box fallback
        print(f"detector {path}: {family} native conversion failed ({e}); "
              f"torchscript fallback on {device}")
        return TorchscriptDetector(path, device, fallback_kwargs)


@functools.lru_cache(maxsize=8)
def get_detector(spec: str, device: Union[str, torch.device] = "cuda") -> Callable:
    """Resolve a detector spec to a detector on `device`:
    * "stub:<dim>"                          -> StubDetector (tests; numpy)
    * "<family>:<path>" (i3d/inception/c3d) -> native conversion of that file
    * bare family name ("i3d", ...)         -> $LVG_DETECTOR_DIR/<default file>
    * a filesystem path whose basename EXACTLY matches a published detector
      file name                             -> native conversion
    * any other filesystem path             -> black-box torchscript (no guessing)
    """
    device = torch.device(device)
    if spec.startswith("stub:"):
        return StubDetector(dim=int(spec.split(":", 1)[1]))

    # Explicit family prefix: the user asserts the file's architecture.
    for family in ("i3d", "inception", "c3d"):
        if spec.startswith(family + ":"):
            path = spec.split(":", 1)[1]
            if not os.path.isfile(path):
                raise FileNotFoundError(f"detector file {path!r} not found")
            return _native_or_fallback(family, path, device)

    # Bare family name: resolve in $LVG_DETECTOR_DIR.
    if spec in _DEFAULT_FILENAMES:
        path = os.path.join(os.environ.get(DETECTOR_DIR_ENV, ""), _DEFAULT_FILENAMES[spec])
        if os.path.isfile(path):
            return _native_or_fallback(spec, path, device)
        raise FileNotFoundError(
            f"detector {spec!r} not found at {path}; download it from "
            f"{DETECTOR_URLS.get(spec, '<url>')} and set ${DETECTOR_DIR_ENV} "
            f"or pass an explicit '{spec}:<path>'")

    # Filesystem path: native only on an exact published-basename match.
    if os.path.isfile(spec):
        family = _KNOWN_BASENAMES.get(os.path.basename(spec))
        if family is not None:
            return _native_or_fallback(family, spec, device)
        print(f"detector {spec}: unrecognized file name; torchscript on {device} "
              f"(prefix with i3d:/inception:/c3d: to convert natively)")
        return TorchscriptDetector(spec, device)
    raise FileNotFoundError(
        f"detector {spec!r} not found; download it from {DETECTOR_URLS.get(spec, '<url>')} "
        f"and set ${DETECTOR_DIR_ENV} or pass an explicit path")
