"""The port's dataset tools (`long_video_gan_tpu_torch/data/tools/`) against
the JAX package's on the same seeded input: a directory of frame images, mp4
videos written with OpenCV, and a YouTube clip-interval config read through
`--video-dir`. Each pair writes ZIP shards with the same member names,
byte-equal JPEGs and the same frame index. Without cv2 the video tools
raise with a clear message, and without yt-dlp the YouTube tool refuses to
download."""

import json
import sys
import zipfile

import numpy as np
import pytest
from PIL import Image

from long_video_gan_tpu.data.tools import make_dataset_from_frames as jax_frames
from long_video_gan_tpu.data.tools import make_dataset_from_videos as jax_videos
from long_video_gan_tpu.data.tools import make_dataset_from_youtube as jax_youtube
from long_video_gan_tpu_torch.data.tools import (make_dataset_from_frames,
                                                 make_dataset_from_videos,
                                                 make_dataset_from_youtube)

cv2 = pytest.importorskip("cv2")


def _frames(rng, count, height, width):
    """Smooth moving color fields, uint8 [count, height, width, 3]."""
    yy, xx = np.mgrid[0:height, 0:width]
    phase = rng.uniform(0, 2 * np.pi, 3)
    out = []
    for t in range(count):
        frame = np.stack([np.sin(xx / width * 5 + t * 0.4 + phase[c]) * 0.4 + 0.5
                          + 0.1 * np.cos(yy / height * 3) for c in range(3)], axis=-1)
        noise = rng.uniform(-0.05, 0.05, frame.shape)
        out.append((np.clip(frame + noise, 0, 1) * 255).astype(np.uint8))
    return np.stack(out)


def _write_mp4(path, frames, fps=10):
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (frames.shape[2], frames.shape[1]))
    assert writer.isOpened()
    for frame in frames:
        writer.write(np.ascontiguousarray(frame[:, :, ::-1]))
    writer.release()


def _archive(path):
    """{member: bytes} of a shard, and its frame index."""
    with zipfile.ZipFile(path) as zf:
        members = {name: zf.read(name) for name in zf.namelist()}
    return members, json.loads(members.pop("frame_paths.json"))


def _assert_same_archive(got_path, want_path):
    got, got_index = _archive(got_path)
    want, want_index = _archive(want_path)
    assert sorted(got) == sorted(want)
    assert all(got[name] == want[name] for name in want)
    assert got_index == want_index
    assert sum(len(v) for v in want_index.values()) == len(want) > 0
    return want_index


def test_frames_tool_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    for clip, (h, w) in {"clip_a": (40, 50), "nested/clip_b": (30, 64)}.items():
        (tmp_path / "in" / clip).mkdir(parents=True)
        for t, frame in enumerate(_frames(rng, 5, h, w)):
            Image.fromarray(frame).save(tmp_path / "in" / clip / f"{t:03d}.png")
    args = ["--input", str(tmp_path / "in"), "--height", "16", "--width", "24",
            "--workers", "2"]
    jax_frames.main.main(args=args + ["--output", str(tmp_path / "jax")],
                         standalone_mode=False)
    zip_path = make_dataset_from_frames.main(args + ["--output", str(tmp_path / "port")])
    assert zip_path == tmp_path / "port" / "0016x0024" / "partition_0000.zip"
    index = _assert_same_archive(zip_path, tmp_path / "jax" / "0016x0024" / "partition_0000.zip")
    assert sorted(index) == ["clip_a", "nested/clip_b"]
    assert index["clip_a"] == [f"frame_{t:06d}.jpg" for t in range(5)]


def test_videos_tool_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    (tmp_path / "in" / "sub").mkdir(parents=True)
    _write_mp4(tmp_path / "in" / "a.mp4", _frames(rng, 12, 48, 64))
    _write_mp4(tmp_path / "in" / "sub" / "b.mp4", _frames(rng, 9, 40, 40))
    for extra in (["--height", "16", "--width", "24"], ["--long-edge", "20", "--trim-end", "0.3"]):
        args = ["--input", str(tmp_path / "in"), "--workers", "2", *extra]
        jax_videos.main.main(args=args + ["--output", str(tmp_path / "jax")],
                             standalone_mode=False)
        zip_path = make_dataset_from_videos.main(args + ["--output", str(tmp_path / "port")])
        res = zip_path.parent.name
        index = _assert_same_archive(zip_path, tmp_path / "jax" / res / "partition_0000.zip")
        assert sorted(index) == ["a", "sub/b"]
    assert res == "long20" and len(index["a"]) < 12


def test_youtube_tool_matches_jax_offline(tmp_path):
    rng = np.random.default_rng(2)
    (tmp_path / "raw").mkdir()
    _write_mp4(tmp_path / "raw" / "vidA.mp4", _frames(rng, 20, 36, 64))
    _write_mp4(tmp_path / "raw" / "vidB.mp4", _frames(rng, 15, 36, 48))
    config = {"vidA": [["0:00", "0:00.8"], ["0:01", "0:01.5"]], "vidB": [["0", "1"]],
              "missing": [["0", "1"]]}
    (tmp_path / "config.json").write_text(json.dumps(config))
    args = ["--config", str(tmp_path / "config.json"), "--video-dir", str(tmp_path / "raw"),
            "--height", "12", "--width", "16"]
    jax_youtube.main.main(args=args + ["--output", str(tmp_path / "jax")], standalone_mode=False)
    zip_path = make_dataset_from_youtube.main(args + ["--output", str(tmp_path / "port")])
    index = _assert_same_archive(zip_path, tmp_path / "jax" / "0012x0016" / "partition_0000.zip")
    assert sorted(index) == ["vidA/clip_0000", "vidA/clip_0001", "vidB/clip_0000"]


def test_video_tools_need_cv2_and_yt_dlp(tmp_path, monkeypatch):
    monkeypatch.setattr(make_dataset_from_youtube.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="yt-dlp is not installed"):
        make_dataset_from_youtube.download_video("vidA", tmp_path)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="needs OpenCV"):
        list(make_dataset_from_videos.iter_video_frames(tmp_path / "a.mp4"))
