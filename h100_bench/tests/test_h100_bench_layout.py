"""The harness is driven by data: a cell, a configuration, a traffic mix
and a per-layer metric added as new files are found by name, with no edit
of a file that is there; and what runs imports neither JAX nor the JAX
package (the reference not the program either)."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from h100_bench import run as bench_run

ROOT = Path(bench_run.__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "long_video_gan_tpu")


def test_additions_are_found_without_an_edit(tmp_path):
    bench = tmp_path / "h100_bench"
    shutil.copytree(ROOT / "h100_bench", bench, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    config = json.loads((bench / "configs" / "sres-144x256.json").read_text())
    config["name"] = "sres-72x128"
    config["model"] = dict(config["model"], hr_height=72, hr_width=128)
    (bench / "configs" / "sres-72x128.json").write_text(json.dumps(config))
    traffic = json.loads((bench / "traffic" / "sres-stream.json").read_text())
    (bench / "traffic" / "sres-stream-b1-short.json").write_text(
        json.dumps(dict(traffic, name="sres-stream-b1-short", frames_per_video=256)))
    (bench / "cells" / "sres-stream-72.json").write_text(json.dumps(
        {"name": "sres-stream-72", "config": "sres-72x128", "traffic": "sres-stream-b1-short",
         "chips": 1, "limits": {"segment_rel_rms": 0.03}}))
    (bench / "metrics" / "segments.gen.py").write_text(
        "def read(ctx):\n    return float(ctx['frames']) / 16\n")
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    manifest["workloads"].append({"name": "sres-stream-72", "config": "sres-72x128",
                                  "traffic": "sres-stream-b1-short", "chips": 1, "why": "t"})
    for m in manifest["end_to_end"]:
        if "sres-stream" in m.get("workloads", []):
            m["workloads"].append("sres-stream-72")
    manifest["per_layer"].append({"name": "segments.gen", "unit": "count", "better": "higher",
                                  "source": "program_counter", "layer": "generate",
                                  "moves": "gen_frames_per_s", "workloads": ["sres-stream-72"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    cell, cfg, tr = bench_run.load_cell("sres-stream-72", bench)
    assert cfg["model"]["hr_height"] == 72 and tr["frames_per_video"] == 256
    e2e, per_layer = bench_run.benchmark_entries("sres-stream-72", tmp_path)
    assert {m["name"] for m in e2e} == {"gen_frames_per_s", "segment_ms_p95", "peak_mem_gib",
                                       "setup_s"}
    assert [m["name"] for m in per_layer] == ["segments.gen"]
    assert bench_run.metric_reader("segments.gen", bench)({"frames": 64}) == 4.0
    assert bench_run.driver_for(tr).__module__ == "h100_bench.drivers.stream"
    for path, data in before.items():
        assert path.read_bytes() == data, path


def test_every_manifest_entry_has_its_files():
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in manifest["workloads"]:
        cell, config, traffic = bench_run.load_cell(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"]) == (
            w["config"], w["traffic"], w["chips"])
        bench_run.driver_for(traffic)
        _, per_layer = bench_run.benchmark_entries(w["name"])
        for m in per_layer:
            assert callable(bench_run.metric_reader(m["name"]))
        assert cell["limits"]
    for c in manifest["configs"]:
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]


def loaded_modules(code: str) -> list[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted(sys.modules)))"],
                         cwd=ROOT, capture_output=True, text=True, check=True).stdout
    return json.loads(out.splitlines()[-1])


def top_level(names):
    return {n.split(".")[0] for n in names}


@pytest.mark.parametrize("cell", ["sres-stream", "sres-train"])
def test_harness_imports_no_jax(cell):
    """`h100_bench.run` with the cell's driver, the program modules it
    drives and its metric readers."""
    code = (
        "from h100_bench import run\n"
        f"cell, config, traffic = run.load_cell({cell!r})\n"
        "run.driver_for(traffic)\n"
        f"for m in run.benchmark_entries({cell!r})[1]: run.metric_reader(m['name'])\n"
        "import h100_bench.trace, h100_bench.flops\n"
        "import long_video_gan_tpu_torch.generate, long_video_gan_tpu_torch.train.gan_sres\n")
    names = top_level(loaded_modules(code))
    assert not names & set(FORBIDDEN), sorted(names & set(FORBIDDEN))
    assert "long_video_gan_tpu_torch" in names


def test_reference_imports_no_program():
    code = "\n".join(f"import h100_bench.reference.{p.stem}"
                     for p in sorted((ROOT / "h100_bench" / "reference").glob("*.py"))
                     if p.stem != "__init__")
    names = top_level(loaded_modules(code))
    assert not names & {*FORBIDDEN, "long_video_gan_tpu_torch"}, sorted(names)


def test_run_refuses_without_the_chips(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert bench_run.main(["--workload", "sres-stream", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
