"""Batched JPEG decoding: the native C++ threadpool decoder, with a PIL
fallback.

The port's own copy of `long_video_gan_tpu/data/jpeg.py`. The native decoder
(`csrc/jpeg_decoder.cpp`, bound by `jpeg_native.py`) decodes a batch across a
libjpeg(-turbo) threadpool in one call; where it cannot be built (no g++ or
libjpeg), decoding falls back to PIL on the host.
"""

from __future__ import annotations

import threading

import numpy as np

_native = None
_native_checked = False
# The loader's threads and the main thread decode at once: the first builds
# the decoder while the others wait for it, not fall back to PIL.
_native_lock = threading.Lock()


def _load_native():
    global _native, _native_checked
    with _native_lock:
        if _native_checked:
            return _native
        try:
            from . import jpeg_native

            _native = jpeg_native
        except Exception as e:
            import warnings

            warnings.warn(
                f"native JPEG decoder unavailable ({type(e).__name__}: {e}); "
                "falling back to PIL (~3.5x slower batch decode).")
            _native = None
        _native_checked = True
        return _native


def decode_jpeg_batch(blobs: list[bytes]) -> np.ndarray:
    """Decode same-sized JPEGs to [N, H, W, 3] uint8 RGB."""
    native = _load_native()
    if native is not None:
        return native.decode_batch(blobs)
    return _decode_batch_pil(blobs)


def _decode_batch_pil(blobs: list[bytes]) -> np.ndarray:
    import io

    from PIL import Image

    frames = []
    for blob in blobs:
        img = Image.open(io.BytesIO(blob))
        arr = np.asarray(img.convert("RGB"), dtype=np.uint8)
        frames.append(arr)
    return np.stack(frames)
