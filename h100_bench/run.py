"""Run one cell of the port's H100 benchmark once.

    python -m h100_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is `h100_bench/cells/<cell>.json`: it names its configuration
(`configs/<name>.json`), its traffic (`traffic/<name>.json`, whose `driver`
names the module under `drivers/` that generates it) and its end-to-end
metrics, and holds the limits of its correctness check. The per-layer
metrics of a traced run are the `per_layer` entries of `BENCHMARK.json` that
list the cell, each read by `metrics/<name>.py`. So a cell, a configuration,
a traffic mix or a metric is added by adding files and entries.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device` (with `busy_s` and `window_s`
when traced), `breakdown` when traced, and last `checked`, each compared
number with its limit; the same numbers end standard error. Without as many
CUDA devices as the cell asks for, or with JAX loaded once the window has
closed, it prints no result and exits non-zero. `--control 1` puts the
reference, one precision lower, in the program's place in the check and
compares it with the reference at full precision (the control of the
limits; the benchmark's own runs never pass it).
"""

from __future__ import annotations

import os
import sys
import time

_CLOCK_AT_IMPORT = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# Build and kernel caches live in the checkout, at fixed paths.
CACHE_DIR = ROOT / ".bench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE_DIR / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE_DIR / "triton")
os.environ["USE_FLAX"] = "0"

FORBIDDEN = ("jax", "jaxlib", "flax", "long_video_gan_tpu")
GIB = 2 ** 30


def process_start() -> float:
    """The process's start on the epoch clock, from /proc (else the time
    this module was imported)."""
    try:
        with open("/proc/self/stat") as fp:
            ticks = int(fp.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as fp:
            boot = next(int(line.split()[1]) for line in fp if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return _CLOCK_AT_IMPORT


def load_cell(name: str, bench_dir: Path = BENCH_DIR) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic) of the cell `name`, found by name."""
    def read(*parts):
        with open(bench_dir.joinpath(*parts)) as fp:
            return json.load(fp)

    cell = read("cells", f"{name}.json")
    return cell, read("configs", f"{cell['config']}.json"), read("traffic",
                                                                  f"{cell['traffic']}.json")


def benchmark_entries(name: str, root: Path = ROOT) -> tuple[list[dict], list[dict]]:
    """The end-to-end and per-layer entries of BENCHMARK.json whose
    `workloads` list `name`; an entry without that list is every cell's."""
    with open(root / "BENCHMARK.json") as fp:
        bench = json.load(fp)

    def listed(m):
        return name in m.get("workloads", [name])

    return ([m for m in bench["end_to_end"] if listed(m)],
            [m for m in bench["per_layer"] if listed(m)])


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """`read(ctx)` of `metrics/<name>.py`."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"h100_bench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def driver_for(traffic: dict):
    return importlib.import_module(f"h100_bench.drivers.{traffic['driver']}").Driver


def run_cell(run, e2e: list[dict], per_layer: list[dict], started: float,
             bench_dir: Path = BENCH_DIR) -> dict:
    """Set up, measure (or trace), free, check: the result object."""
    import torch

    from .common import sync

    cuda = run.device.type == "cuda"
    driver = driver_for(run.traffic)(run)
    driver.setup()
    sync(run.device)
    setup_peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(run.device)
    setup_s = time.time() - started
    device = {"platform": "gpu" if cuda else run.device.type,
              "kind": torch.cuda.get_device_name(run.device) if cuda else "cpu",
              "count": run.cell["chips"]}
    result = {}
    if run.trace:
        ctx = driver.traced()
        tr = ctx["trace"]
        metrics = {}
        for m in per_layer:
            value = metric_reader(m["name"], bench_dir)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    else:
        values = driver.measure()
        values["setup_s"] = setup_s
        values["peak_mem_gib"] = (torch.cuda.max_memory_allocated(run.device) / GIB
                                  if cuda else 0.0)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in e2e}
    window_peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    device["memory_peak_bytes"] = max(setup_peak, window_peak)
    attempted = driver.attempted
    driver.free()
    numbers = driver.check(run.control)
    limits = run.cell["limits"]
    checked = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    failed = sum(1 for c in checked.values() if not c["value"] <= c["limit"])
    correct = failed == 0 and numbers.get("compared", 0) > 0
    return {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
            "device": device, **result, "checked": checked}


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    started = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell, config, traffic = load_cell(args.workload)
    e2e, per_layer = benchmark_entries(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    from .common import Run

    run = Run(cell=cell, config=config, traffic=traffic, seed=args.seed, seconds=args.seconds,
              trace=bool(args.trace), device=torch.device("cuda", 0), control=bool(args.control))
    result = run_cell(run, e2e, per_layer, started)
    leaked = forbidden_modules()
    if leaked:
        print(f"JAX or the JAX package was loaded: {leaked[:10]}", file=sys.stderr)
        return 3
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, c in result["checked"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
