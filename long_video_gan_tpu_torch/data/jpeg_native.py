"""ctypes binding of the native batched JPEG decoder (`csrc/jpeg_decoder.cpp`,
g++ and libjpeg), built at import into `long_video_gan_tpu_torch/_build/`,
named by a hash of the source and the flags. Importing raises where it cannot
be built (with the compiler's output); `jpeg.py` then decodes with PIL."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

from ..utils.nvcc import BUILD_DIR, CSRC_DIR

GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
GXX_LIBS = ("-ljpeg", "-lpthread")


def build() -> str:
    """Compile the decoder unless a library of the same hash exists."""
    src = CSRC_DIR / "jpeg_decoder.cpp"
    digest = hashlib.sha256(src.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libjpeg_decoder-{digest}.so"
    if out.is_file():
        return str(out)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Temp name + rename: atomic against several processes building at once.
    tmp = BUILD_DIR / f".{out.name}.{os.getpid()}.tmp"
    cmd = ["g++", *GXX_FLAGS, str(src), "-o", str(tmp), *GXX_LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return str(out)


_lib = ctypes.CDLL(build())
_lib.lvg_decoder_create.restype = ctypes.c_void_p
_lib.lvg_decoder_create.argtypes = [ctypes.c_int]
_lib.lvg_decoder_destroy.argtypes = [ctypes.c_void_p]
_lib.lvg_probe.restype = ctypes.c_int
_lib.lvg_probe.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                           ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                           ctypes.POINTER(ctypes.c_int)]
_lib.lvg_decode_batch.restype = ctypes.c_int
_lib.lvg_decode_batch.argtypes = [
    ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
    ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
]

_pool = _lib.lvg_decoder_create(int(os.environ.get("LVG_DECODE_THREADS", "0")))


def probe(blob: bytes) -> tuple[int, int, int]:
    h = ctypes.c_int()
    w = ctypes.c_int()
    c = ctypes.c_int()
    rc = _lib.lvg_probe(blob, len(blob), ctypes.byref(h), ctypes.byref(w), ctypes.byref(c))
    if rc != 0:
        raise ValueError("invalid JPEG")
    return h.value, w.value, c.value


def decode_batch(blobs: list[bytes]) -> np.ndarray:
    """Decode same-sized RGB JPEGs to [N, H, W, 3] uint8 across the pool."""
    n = len(blobs)
    assert n > 0
    h, w, c = probe(blobs[0])
    out = np.empty((n, h, w, c), dtype=np.uint8)
    blob_ptrs = (ctypes.c_char_p * n)(*blobs)
    sizes = (ctypes.c_size_t * n)(*[len(b) for b in blobs])
    rc = _lib.lvg_decode_batch(_pool, blob_ptrs, sizes, n,
                               out.ctypes.data_as(ctypes.c_void_p), h, w, c)
    if rc != 0:
        raise ValueError(f"JPEG batch decode failed (code {rc})")
    return out
