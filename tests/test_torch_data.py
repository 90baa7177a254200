"""The port's data modules on the CPU: the native JPEG decoder's build."""

import importlib
import os
import sys

import pytest

from long_video_gan_tpu_torch.utils import nvcc

MODULE = "long_video_gan_tpu_torch.data.jpeg_native"


def test_native_build_raises_with_the_compilers_error(tmp_path, monkeypatch):
    """A g++ that fails makes the import raise with its exit code and what it
    wrote to stderr, which `jpeg.py`'s PIL-fallback warning then shows; a
    fresh build directory keeps a cached library from being taken."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    gxx = bin_dir / "g++"
    gxx.write_text("#!/bin/sh\necho 'jpeg_decoder.cpp:1: error: the stand-in refuses' >&2\n"
                   "exit 3\n")
    gxx.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path / "build")
    monkeypatch.delitem(sys.modules, MODULE, raising=False)
    with pytest.raises(RuntimeError, match=r"g\+\+ failed \(3\)[\s\S]*the stand-in refuses"):
        importlib.import_module(MODULE)
    assert not list((tmp_path / "build").iterdir())
