"""Batched JPEG decoding: the native C++ threadpool decoder, with a PIL
fallback; and JPEG encoding for the dataset tools.

The port's own copy of `long_video_gan_tpu/data/jpeg.py`. The native decoder
(`csrc/jpeg_decoder.cpp`, bound by `jpeg_native.py`) decodes a batch across a
libjpeg(-turbo) threadpool in one call. It links the system's libjpeg, or
else the libjpeg-turbo in Pillow's wheel; where neither builds (no g++, or
no libjpeg at all), decoding falls back to PIL on the host, and
`decoder_in_use()` says so.
"""

from __future__ import annotations

import threading

import numpy as np

_native = None
_native_checked = False
_native_error = None
# The loader's threads and the main thread decode at once: the first builds
# the decoder while the others wait for it, not fall back to PIL.
_native_lock = threading.Lock()


def _load_native():
    global _native, _native_checked, _native_error
    with _native_lock:
        if _native_checked:
            return _native
        try:
            from . import jpeg_native

            _native = jpeg_native
        except Exception as e:
            import warnings

            _native_error = f"{type(e).__name__}: {e}"
            warnings.warn(f"native JPEG decoder unavailable ({_native_error}); "
                          "falling back to PIL.")
            _native = None
        _native_checked = True
        return _native


def decoder_in_use() -> str:
    """"native" with the libjpeg it loaded (its route and path), or "PIL"
    with the reason the native decoder did not load."""
    native = _load_native()
    if native is not None:
        return f"native ({native.ROUTE.name} libjpeg {native.ROUTE.library})"
    return f"PIL ({_native_error})"


def decode_jpeg(blob: bytes) -> np.ndarray:
    """Decode one JPEG to [H, W, 3] uint8 RGB."""
    return decode_jpeg_batch([blob])[0]


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


def encode_jpeg(array: np.ndarray, quality: int = 95, subsampling: str = "4:2:0") -> bytes:
    """Encode [H, W, 3] uint8 RGB to JPEG bytes (dataset tools)."""
    import io

    from PIL import Image

    buf = io.BytesIO()
    ss = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}[subsampling]
    Image.fromarray(array).save(buf, format="jpeg", quality=quality, subsampling=ss)
    return buf.getvalue()
