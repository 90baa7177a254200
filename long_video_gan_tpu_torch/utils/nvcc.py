"""Build a CUDA source into a shared library with nvcc and load it with ctypes.

The library gets a plain C interface (no PyTorch headers), which keeps a build
to seconds. It is built at first use into `long_video_gan_tpu_torch/_build/`,
named by a hash of the source, the shared `csrc/*.cuh` headers and the flags,
so an edited source rebuilds and an unchanged one loads the library already
there. The compiler's report (ptxas: registers, shared memory and spills of
every kernel) is kept beside the library as `<library>.log`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                       "the CUDA kernels build only where the CUDA toolkit is installed")


def build_library(source_name: str | Path) -> Path:
    """Compile `csrc/<source_name>` (or the source at an absolute path, which
    may include the `csrc/` headers) unless a library of the same hash
    exists."""
    src = CSRC_DIR / source_name
    # The shared headers count too: a source that includes an edited header
    # rebuilds.
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{src.stem}-{digest}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Temp name + rename: atomic against several processes building at once.
    tmp = BUILD_DIR / f".{out.name}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp), str(src)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def load_library(source_name: str | Path, signatures: dict[str, list]) -> ctypes.CDLL:
    """Build and load `csrc/<source_name>` (as `build_library`); each named C
    function of `signatures` takes those ctypes argument types and returns a
    cudaError_t (an int), which `lvg_cuda_error_string` turns into its
    message."""
    lib = ctypes.CDLL(str(build_library(source_name)))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.lvg_cuda_error_string.argtypes = [ctypes.c_int]
    lib.lvg_cuda_error_string.restype = ctypes.c_char_p
    return lib
