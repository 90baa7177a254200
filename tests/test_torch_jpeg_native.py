"""The port's native JPEG decoder on the route a host without a system
libjpeg takes: built against the libjpeg 6.2 headers in `csrc/libjpeg62/`
and the libjpeg-turbo of Pillow's wheel, held to PIL (the same library) and
to the JAX package's native decoder; the build names and errors of both
routes; `decode_jpeg`."""

import os
import shutil
import subprocess

import numpy as np
import pytest

from long_video_gan_tpu.data import jpeg as jax_jpeg
from long_video_gan_tpu.data import jpeg_native as jax_jpeg_native
from long_video_gan_tpu_torch.data import jpeg, jpeg_native

# Odd sizes (the probe test's) and the trainers' two resolutions, in both
# chroma subsamplings the dataset tools write.
CASES = [(17, 23, "4:2:0"), (17, 23, "4:4:4"), (36, 64, "4:2:0"), (36, 64, "4:4:4"),
         (144, 256, "4:2:0"), (144, 256, "4:4:4")]
FRAMES = 4


def _gxx_without_system_libjpeg(root) -> str:
    """A bin directory whose g++ is the real one on a host without a system
    libjpeg: it refuses `-ljpeg`, finds no libjpeg.so, and a `jpeglib.h` that
    stops the compile stands where the system's would be found."""
    real = shutil.which("g++")
    inc = root / "inc"
    inc.mkdir()
    (inc / "jpeglib.h").write_text("#error the system jpeglib.h is not there\n")
    bin_dir = root / "bin"
    bin_dir.mkdir()
    gxx = bin_dir / "g++"
    gxx.write_text("#!/bin/sh\n"
                   "for a in \"$@\"; do\n"
                   "  [ \"$a\" = -ljpeg ] && { echo 'ld: cannot find -ljpeg' >&2; exit 1; }\n"
                   "done\n"
                   "[ \"$1\" = -print-file-name=libjpeg.so ] && { echo libjpeg.so; exit 0; }\n"
                   f"exec {real} \"$@\" -I{inc}\n")
    gxx.chmod(0o755)
    return str(bin_dir)


@pytest.fixture(scope="module")
def no_system_libjpeg(tmp_path_factory):
    """PATH with that g++ first, and a fresh build directory."""
    root = tmp_path_factory.mktemp("no_system_libjpeg")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PATH", f"{_gxx_without_system_libjpeg(root)}{os.pathsep}{os.environ['PATH']}")
        mp.setattr(jpeg_native, "BUILD_DIR", root / "build")
        yield root / "build"


@pytest.fixture(scope="module")
def pillow_decoder(no_system_libjpeg):
    """The decoder as `open_decoder` gives it where the system route fails."""
    decoder = jpeg_native.open_decoder()
    yield decoder
    decoder.close()


def _blobs(h, w, subsampling, seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, size=(FRAMES, h, w, 3), dtype=np.uint8)
    return [jpeg.encode_jpeg(f, quality=95, subsampling=subsampling) for f in frames]


def test_pillow_route_is_taken_without_a_system_libjpeg(pillow_decoder, no_system_libjpeg):
    """The system route fails there, so the decoder links the libjpeg-turbo
    of Pillow's wheel (found by name beside `PIL`), built into the build
    directory under the name of that route."""
    route = pillow_decoder.route
    assert route.name == "pillow"
    assert route.library == str(jpeg_native.pillow_libjpeg().resolve())
    assert os.path.basename(route.library).startswith("libjpeg-")
    assert ".so.62" in route.library
    assert pillow_decoder.path == str(jpeg_native.library_path(route))
    assert os.path.dirname(pillow_decoder.path) == str(no_system_libjpeg)


def test_pillow_route_compiles_against_the_vendored_headers(no_system_libjpeg):
    """The libjpeg headers the source includes on that route are the
    repository's copies, not the system's."""
    route = jpeg_native.pillow_route()
    deps = subprocess.run(["g++", "-M", "-std=c++17", *route.cflags, str(jpeg_native.SOURCE)],
                          capture_output=True, text=True, check=True).stdout
    for name in ("jpeglib.h", "jconfig.h", "jmorecfg.h"):
        assert str(jpeg_native.HEADERS / name) in deps
    assert "/usr/include/jpeglib.h" not in deps


@pytest.mark.parametrize("h,w,subsampling", CASES)
def test_pillow_route_decodes_bit_equal_to_pil(pillow_decoder, h, w, subsampling):
    """The same libjpeg-turbo as PIL's, so the same bytes."""
    blobs = _blobs(h, w, subsampling)
    got = pillow_decoder.decode_batch(blobs)
    want = jpeg._decode_batch_pil(blobs)
    assert got.shape == want.shape == (FRAMES, h, w, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w,subsampling", CASES)
def test_pillow_route_within_one_level_of_the_jax_decoder(pillow_decoder, h, w, subsampling):
    """Against the JAX package's native decoder (the system's libjpeg here):
    within 1 level, the bar of the JAX package's own native-decoder test."""
    blobs = _blobs(h, w, subsampling, seed=1)
    got = pillow_decoder.decode_batch(blobs)
    want = jax_jpeg_native.decode_batch(blobs)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_routes_get_different_build_names(tmp_path, monkeypatch):
    """The name covers the route, the libjpeg it links and the vendored
    headers' bytes, so a build from one host is not taken on another."""
    system, pillow = jpeg_native.system_route(), jpeg_native.pillow_route()
    names = {jpeg_native.library_path(system), jpeg_native.library_path(pillow)}
    other_lib = jpeg_native.Route("pillow", "/elsewhere/pillow.libs/libjpeg-0.so.62.4.0",
                                  pillow.cflags, pillow.libs)
    names.add(jpeg_native.library_path(other_lib))
    headers = tmp_path / "libjpeg62"
    shutil.copytree(jpeg_native.HEADERS, headers)
    with open(headers / "jconfig.h", "a") as f:
        f.write("\n")
    monkeypatch.setattr(jpeg_native, "HEADERS", headers)
    names.add(jpeg_native.library_path(pillow))
    assert len(names) == 4
    monkeypatch.undo()
    assert jpeg_native.library_path(pillow) in names


@pytest.mark.parametrize("pillow_libs", [True, False], ids=["both_fail_to_compile",
                                                           "no_pillow_libjpeg"])
def test_error_names_both_routes(tmp_path, monkeypatch, pillow_libs):
    """Where no route builds, the error has each route's attempt: the
    compiler's output of each, or why the wheel's libjpeg was not found."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    gxx = bin_dir / "g++"
    gxx.write_text("#!/bin/sh\necho \"stand-in g++ refuses: $*\" >&2\nexit 3\n")
    gxx.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(jpeg_native, "BUILD_DIR", tmp_path / "build")
    if not pillow_libs:
        def missing():
            raise FileNotFoundError("no [Pp]illow.libs/libjpeg-*.so.62* in /nowhere")
        monkeypatch.setattr(jpeg_native, "pillow_libjpeg", missing)
    with pytest.raises(RuntimeError) as info:
        jpeg_native.open_decoder()
    message = str(info.value)
    system, pillow = message.split("[system]")[1].split("[pillow]")
    assert "g++ failed (3)" in system and "refuses:" in system and " -ljpeg" in system
    if pillow_libs:
        assert "g++ failed (3)" in pillow and "-l:libjpeg-" in pillow
        assert f"-I {jpeg_native.HEADERS}" in pillow
    else:
        assert "FileNotFoundError: no [Pp]illow.libs" in pillow
    assert not (tmp_path / "build").exists() or not list((tmp_path / "build").iterdir())


def test_decode_jpeg_matches_the_jax_package():
    """`decode_jpeg`, the JAX package's one-frame call: [H, W, 3] uint8, the
    first frame of a batch of one, within 1 level of the JAX package's."""
    blob = _blobs(17, 23, "4:2:0", seed=2)[0]
    got = jpeg.decode_jpeg(blob)
    assert got.shape == (17, 23, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jpeg.decode_jpeg_batch([blob])[0])
    assert np.abs(got.astype(int) - jax_jpeg.decode_jpeg(blob).astype(int)).max() <= 1


def test_decoder_in_use_names_the_library_it_loaded():
    """"native" with the route and the libjpeg's path, which the trainers
    print and write to config.json."""
    assert jpeg.decoder_in_use() == (f"native ({jpeg_native.ROUTE.name} libjpeg "
                                     f"{jpeg_native.ROUTE.library})")
    assert os.path.isfile(jpeg_native.ROUTE.library)
