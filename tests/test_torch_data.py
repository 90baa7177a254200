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


def test_decoder_loads_once_for_threads_that_decode_at_once(monkeypatch):
    """The loader's threads and the main thread ask for the decoder together:
    each waits for the one build instead of falling back to PIL while it
    runs."""
    import importlib.abc
    import importlib.util
    import threading
    import time
    import types

    from long_video_gan_tpu_torch.data import jpeg

    class SlowLoader(importlib.abc.Loader):
        def create_module(self, spec):
            time.sleep(0.3)                    # a build that takes a while
            return types.ModuleType(spec.name)

        def exec_module(self, module):
            module.decode_batch = None

    class Finder(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            return importlib.util.spec_from_loader(name, SlowLoader()) if name == MODULE else None

    monkeypatch.delitem(sys.modules, MODULE, raising=False)
    monkeypatch.delattr(sys.modules["long_video_gan_tpu_torch.data"], "jpeg_native",
                        raising=False)
    monkeypatch.setattr(sys, "meta_path", [Finder()] + sys.meta_path)
    monkeypatch.setattr(jpeg, "_native", None)
    monkeypatch.setattr(jpeg, "_native_checked", False)
    got = []
    threads = [threading.Thread(target=lambda: got.append(jpeg._load_native()))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(got) == 4 and all(m is sys.modules[MODULE] for m in got)


def test_loader_raises_when_its_producer_fails():
    """A sample that raises in the loader's thread is raised to the consumer
    (with that error as its cause), on every later call too, instead of
    leaving it waiting for a batch."""
    from long_video_gan_tpu_torch.data.loader import InfiniteLoader

    class Broken:
        def __len__(self):
            return 4

        def sample(self, index, rng):
            raise ValueError("unreadable frame")

    import threading

    loader = InfiniteLoader(Broken(), batch_size=2, num_workers=1)
    errors = []

    def consume():
        for _ in range(2):
            try:
                next(loader)
            except RuntimeError as e:
                errors.append(e)

    consumer = threading.Thread(target=consume, daemon=True)
    consumer.start()
    consumer.join(timeout=30)
    loader.close()
    assert not consumer.is_alive(), "the consumer still waits for a batch"
    assert len(errors) == 2
    for e in errors:
        assert "producer thread failed" in str(e) and isinstance(e.__cause__, ValueError)
