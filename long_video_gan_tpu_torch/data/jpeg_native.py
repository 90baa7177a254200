"""ctypes binding of the native batched JPEG decoder (`csrc/jpeg_decoder.cpp`,
g++ and libjpeg), built at import into `long_video_gan_tpu_torch/_build/`.

It links the first libjpeg of `ROUTES` that builds:

- "system": the system's `-ljpeg` with its `jpeglib.h`, where g++ finds both;
- "pillow": the libjpeg-turbo that Pillow's wheel carries beside the `PIL`
  package (`pillow.libs/libjpeg-<hash>.so.62.*`, the library PIL decodes
  with), compiled against the libjpeg 6.2 headers kept in `csrc/libjpeg62/`
  (libjpeg-turbo 2.1.5's, the ABI of `libjpeg.so.62`) and linked by its file
  name with an rpath to its directory.

The library is named by a hash of the source, those headers, the flags, the
route, the libjpeg it links and `toolchain_key()`, so that a build directory
copied from another machine is not loaded here. Importing raises where no
route builds, with each route's error; `jpeg.py` then decodes with PIL."""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import platform
import subprocess
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..utils.nvcc import BUILD_DIR, CSRC_DIR

SOURCE = CSRC_DIR / "jpeg_decoder.cpp"
HEADERS = CSRC_DIR / "libjpeg62"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


def _gxx(*args: str) -> str:
    return subprocess.run(["g++", *args], capture_output=True, text=True).stdout.strip()


def _gxx_libjpeg() -> str:
    """The libjpeg.so g++ links with `-ljpeg`: its resolved path, or the bare
    name g++ prints where it finds none."""
    libjpeg = _gxx("-print-file-name=libjpeg.so")
    return os.path.realpath(libjpeg) if os.path.isabs(libjpeg) else libjpeg


def toolchain_key() -> str:
    """What a library built here depends on besides its source and flags:
    the machine, the g++ version, the CPU that `-march=native` resolves to,
    and the libjpeg that g++ links (its resolved path; a bare name when g++
    finds none)."""
    march = [line.split()[-1] for line in _gxx("-march=native", "-Q", "--help=target").splitlines()
             if line.strip().startswith("-march=")]
    return "\n".join([platform.machine(), _gxx("--version").split("\n")[0], *march[:1],
                      _gxx_libjpeg()])


@dataclass(frozen=True)
class Route:
    """One way to build the decoder: the libjpeg it links (a real path, or
    g++'s bare name where it finds none) and the g++ arguments that take it,
    before the source (`cflags`) and after it (`libs`)."""

    name: str
    library: str
    cflags: tuple[str, ...]
    libs: tuple[str, ...]


def system_route() -> Route:
    return Route("system", _gxx_libjpeg(), (), ("-ljpeg",))


def pillow_libjpeg() -> Path:
    """The libjpeg-turbo of Pillow's wheel, found by name beside the `PIL`
    package (the wheel's `pillow.libs/`, its hash in the file name)."""
    spec = importlib.util.find_spec("PIL")
    if spec is None or spec.origin is None:
        raise FileNotFoundError("PIL is not installed")
    site = Path(spec.origin).resolve().parent.parent
    found = sorted(site.glob("[Pp]illow.libs/libjpeg-*.so.62*"))
    if not found:
        raise FileNotFoundError(f"no [Pp]illow.libs/libjpeg-*.so.62* in {site}")
    return found[0]


def pillow_route() -> Route:
    lib = pillow_libjpeg().resolve()
    return Route("pillow", str(lib), ("-I", str(HEADERS)),
                 (f"-L{lib.parent}", f"-l:{lib.name}", f"-Wl,-rpath,{lib.parent}"))


# In the order they are tried.
ROUTES = {"system": system_route, "pillow": pillow_route}


def library_path(route: Route | None = None) -> Path:
    """The library's path in the build directory for this source, the
    vendored headers, these flags, `route` (the system one by default) and
    `toolchain_key()`."""
    route = route or system_route()
    key = [SOURCE.read_bytes(), *(p.read_bytes() for p in sorted(HEADERS.glob("*.h"))),
           " ".join(GXX_FLAGS).encode(), route.name.encode(), route.library.encode(),
           " ".join(route.cflags + route.libs).encode(), toolchain_key().encode()]
    digest = hashlib.sha256(b"\0".join(key)).hexdigest()[:16]
    return BUILD_DIR / f"libjpeg_decoder-{digest}.so"


def build(route: Route) -> str:
    """Compile the decoder on `route` unless a library of the same name
    exists."""
    out = library_path(route)
    if out.is_file():
        return str(out)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Temp name + rename: atomic against several processes building at once.
    tmp = BUILD_DIR / f".{out.name}.{os.getpid()}.tmp"
    cmd = ["g++", *GXX_FLAGS, *route.cflags, str(SOURCE), "-o", str(tmp), *route.libs,
           "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return str(out)


class NativeDecoder:
    """The decoder built on one route and loaded, with its thread pool
    (`LVG_DECODE_THREADS` threads; by default one per core)."""

    def __init__(self, route: Route):
        self.route = route
        self.path = build(route)
        lib = ctypes.CDLL(self.path)
        lib.lvg_decoder_create.restype = ctypes.c_void_p
        lib.lvg_decoder_create.argtypes = [ctypes.c_int]
        lib.lvg_decoder_destroy.argtypes = [ctypes.c_void_p]
        lib.lvg_probe.restype = ctypes.c_int
        lib.lvg_probe.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                  ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_int)]
        lib.lvg_decode_batch.restype = ctypes.c_int
        lib.lvg_decode_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        self._lib = lib
        self._pool = lib.lvg_decoder_create(int(os.environ.get("LVG_DECODE_THREADS", "0")))

    def close(self) -> None:
        """Stop the thread pool."""
        if self._pool:
            self._lib.lvg_decoder_destroy(self._pool)
            self._pool = None

    def probe(self, blob: bytes) -> tuple[int, int, int]:
        h = ctypes.c_int()
        w = ctypes.c_int()
        c = ctypes.c_int()
        rc = self._lib.lvg_probe(blob, len(blob), ctypes.byref(h), ctypes.byref(w),
                                 ctypes.byref(c))
        if rc != 0:
            raise ValueError("invalid JPEG")
        return h.value, w.value, c.value

    def decode_batch(self, blobs: list[bytes]) -> np.ndarray:
        """Decode same-sized RGB JPEGs to [N, H, W, 3] uint8 across the pool."""
        n = len(blobs)
        if n == 0:
            raise ValueError("no JPEG to decode")
        h, w, c = self.probe(blobs[0])
        out = np.empty((n, h, w, c), dtype=np.uint8)
        blob_ptrs = (ctypes.c_char_p * n)(*blobs)
        sizes = (ctypes.c_size_t * n)(*[len(b) for b in blobs])
        rc = self._lib.lvg_decode_batch(self._pool, blob_ptrs, sizes, n,
                                        out.ctypes.data_as(ctypes.c_void_p), h, w, c)
        if rc != 0:
            raise ValueError(f"JPEG batch decode failed (code {rc})")
        return out


def open_decoder() -> NativeDecoder:
    """The decoder on the first of `ROUTES` that builds and loads; raises
    with every route's error where none does."""
    errors = []
    for name, make_route in ROUTES.items():
        try:
            return NativeDecoder(make_route())
        except (OSError, RuntimeError) as e:
            errors.append(f"[{name}] {type(e).__name__}: {e}")
    raise RuntimeError("the native JPEG decoder builds on no route:\n" + "\n".join(errors))


_decoder = open_decoder()
ROUTE = _decoder.route
probe = _decoder.probe
decode_batch = _decoder.decode_batch
