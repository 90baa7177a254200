"""FIR filter design helpers.

A copy of `long_video_gan_tpu/ops/filters.py` (numpy and scipy only): importing
the JAX package's `ops` would import jax. All filter design happens host-side at
model-construction time; modules keep the taps as non-persistent buffers.

Covers the reference's filter families (cited for parity checking):
  * `setup_filter`            — torch_utils/ops/upfirdn2d.py:70-114
  * Kaiser low-pass (firwin)  — model/generator_lres.py:245-263, generator_sres.py:339-350
  * tent / linear filter      — model/generator_lres.py:161-174
  * radial jinc filter        — model/generator_sres.py:352-360
  * binomial [1,3,3,1]        — model/discriminator_lres.py:190
  * wavelet low-pass taps     — model/ada_augment.py:20-37 (standard pywt coefficients)
"""

from __future__ import annotations

import functools

import numpy as np
import scipy.signal
import scipy.special

# ---------------------------------------------------------------------------
# Standard wavelet decomposition low-pass filters (public pywt coefficients),
# used by the ADA augmentation pipeline (sym6 for geometric warps, sym2 for the
# frequency-band filter bank).


def _qmf_highpass(lo: np.ndarray) -> np.ndarray:
    return lo * ((-1.0) ** np.arange(lo.size))


@functools.lru_cache(maxsize=None)
def wavelet_lowpass(name: str) -> np.ndarray:
    """Return orthogonal wavelet decomposition low-pass taps by name."""
    try:
        import pywt  # pragma: no cover - optional

        return np.asarray(pywt.Wavelet(name).dec_lo, dtype=np.float64)
    except Exception:
        pass
    if name not in _WAVELETS:
        raise KeyError(f"unknown wavelet: {name}")
    return np.asarray(_WAVELETS[name], dtype=np.float64)


# Daubechies/symlet scaling coefficients (public constants, identical to pywt).
_SQRT2 = 1.0 / np.sqrt(2.0)
_WAVELETS = {
    "haar": [_SQRT2, _SQRT2],
    "db1": [_SQRT2, _SQRT2],
    "sym2": [-0.12940952255092145, 0.22414386804185735, 0.836516303737469, 0.48296291314469025],
    "sym6": [
        0.015404109327027373, 0.0034907120842174702, -0.11799011114819057,
        -0.048311742585633, 0.4910559419267466, 0.787641141030194,
        0.3379294217276218, -0.07263752278646252, -0.021060292512300564,
        0.04472490177066578, 0.0017677118642428036, -0.007800708325034148,
    ],
}


# ---------------------------------------------------------------------------


def design_kaiser_lowpass(numtaps: int, cutoff: float, width: float, fs: float) -> np.ndarray:
    """Kaiser-windowed sinc low-pass (scipy.signal.firwin), float32 taps.

    Mirrors the reference's use of firwin for BlurredNoise banks, temporal
    Kaiser resamplers and the StyleGAN3 per-layer filters.
    """
    assert numtaps >= 1
    f = scipy.signal.firwin(numtaps=numtaps, cutoff=cutoff, width=width, fs=fs)
    return np.asarray(f, dtype=np.float32)


def design_lowpass_filter(
    numtaps: int, cutoff: float, width: float, fs: float, radial: bool = False
) -> np.ndarray | None:
    """Per-layer filter design for the alias-free (sres) synthesis layers.

    Returns None for the identity (numtaps == 1), a 1-D separable Kaiser filter,
    or a 2-D radially-symmetric jinc filter with a Kaiser window
    (reference semantics: model/generator_sres.py:339-360).
    """
    assert numtaps >= 1
    if numtaps == 1:
        return None
    if not radial:
        return design_kaiser_lowpass(numtaps, cutoff, width, fs)
    x = (np.arange(numtaps) - (numtaps - 1) / 2) / fs
    r = np.hypot(*np.meshgrid(x, x))
    with np.errstate(divide="ignore", invalid="ignore"):
        f = scipy.special.j1(2 * cutoff * (np.pi * r)) / (np.pi * r)
    # Limit of j1(2*pi*c*r)/(pi*r) as r->0 is c (fill the centre tap).
    f = np.where(r == 0, cutoff, f)
    beta = scipy.signal.kaiser_beta(scipy.signal.kaiser_atten(numtaps, width / (fs / 2)))
    w = np.kaiser(numtaps, beta)
    f = f * np.outer(w, w)
    f = f / np.sum(f)
    return np.asarray(f, dtype=np.float32)


def tent_filter(scale: int) -> np.ndarray:
    """Linear-interpolation ("tent") filter of 2*scale taps, normalized to sum 1.

    Reference semantics: model/generator_lres.py:163-174.
    """
    assert scale > 1 and isinstance(scale, int)
    half = np.linspace(0.5 / scale, 1 - 0.5 / scale, scale)
    f = np.concatenate([half, half[::-1]])
    return np.asarray(f / f.sum(), dtype=np.float32)


def binomial_filter(taps=(1.0, 3.0, 3.0, 1.0)) -> np.ndarray:
    """Normalized binomial filter used by discriminator downsampling."""
    f = np.asarray(taps, dtype=np.float32)
    return f / f.sum()


def kaiser_resample_filter(scale: int, filter_size: int = 6, cutoff: float = 1.0,
                           width: float = 6.0, sampling_rate: float = 4.0) -> np.ndarray:
    """Filter used by (Temporal)Kaiser{Down,Up}sample modules.

    Reference semantics: model/generator_lres.py:245-263, generator_sres.py:481-498.
    """
    assert scale > 1 and isinstance(scale, int)
    return design_kaiser_lowpass(
        numtaps=scale * filter_size, cutoff=cutoff, width=width, fs=scale * sampling_rate
    )


# ---------------------------------------------------------------------------


def setup_filter(
    f,
    normalize: bool = True,
    flip_filter: bool = False,
    gain: float = 1.0,
    separable: bool | None = None,
) -> np.ndarray:
    """Prepare a FIR filter for `upfirdn2d`, as a static numpy constant.

    Accepts a scalar / 1-D / 2-D array or None (identity). Returns float32
    `[fh, fw]` (non-separable) or `[taps]` (separable). Semantics match the
    reference's upfirdn2d.setup_filter (torch_utils/ops/upfirdn2d.py:70-114):
    1-D inputs with >= 8 taps stay separable by default, shorter ones become
    their 2-D outer product; `gain` scales the signal magnitude by
    gain ** (ndim / 2) so a separable filter applied twice yields `gain`.
    """
    if f is None:
        f = 1
    f = np.asarray(f, dtype=np.float32)
    assert f.ndim in (0, 1, 2) and f.size > 0
    if f.ndim == 0:
        f = f[np.newaxis]

    if separable is None:
        separable = f.ndim == 1 and f.size >= 8
    if f.ndim == 1 and not separable:
        f = np.outer(f, f)
    assert f.ndim == (1 if separable else 2)

    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = f[::-1] if f.ndim == 1 else f[::-1, ::-1]
    f = f * (gain ** (f.ndim / 2))
    return np.ascontiguousarray(f, dtype=np.float32)


def filter_size(f) -> tuple[int, int]:
    """(width, height) of a filter prepared by setup_filter; (1, 1) for None."""
    if f is None:
        return 1, 1
    f = np.asarray(f)
    assert f.ndim in (1, 2)
    return int(f.shape[-1]), int(f.shape[0])
