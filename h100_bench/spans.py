"""The program's spans in a traced window, and the device time under them.

`read_spans(path)` reads a chrome trace written by torch.profiler (CPU and
CUDA activity) into a `SpanTrace`, which keeps what `trace.Trace` drops:

  * the program's spans (`user_annotation` events named `lvg.*`) with their
    threads;
  * the launches (`cuda_runtime` and `cuda_driver` events) by their
    `correlation` id, with their threads;
  * the device events (kernels, copies, sets) with their `correlation` id
    and stream.

A device event belongs to every program span on its launch's thread that
holds the launch's time, and to every `lvg.segment`, `lvg.update_*` and
`lvg.adam` span that holds it on any thread: a phase's caller waits in
`backward()` while autograd's thread launches its work. An event whose
launch is not in the trace belongs to no span (`unmatched_s`).

The readings below are per-layer quantities of the two cells:
`upfirdn2d_s` (FIR device time outside `filtered_lrelu`), `filtered_lrelu_s`
(device time of the kernel layers' `filtered_lrelu`, whatever path runs
it), `launch_waits` (idle gaps that end with work launched after the gap
opened: the device waited on the host) and `union_s` of a phase. `run.py`
does not report them: `trace.profile` keeps only device events and `bench.*`
spans before it deletes the chrome trace. `python -m h100_bench.spans
--workload <cell> --seed <n>` runs a cell's traced window once more under
the profiler and prints them as one JSON line, with the per-call-site
tables of FIR device time and launch waits.
"""

from __future__ import annotations

import bisect
import collections
import json
from dataclasses import dataclass, field

from .trace import DEVICE_CATEGORIES, categorize

LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
PREFIX = "lvg."
# Spans that own the work launched inside them on any thread.
ANY_THREAD = ("lvg.segment", "lvg.update_", "lvg.adam")


@dataclass
class Span:
    name: str
    tid: object
    ts: float
    dur: float

    @property
    def end(self) -> float:
        return self.ts + self.dur


@dataclass
class DeviceEvent:
    name: str
    ts: float
    dur: float
    correlation: object
    stream: object


@dataclass
class SpanTrace:
    """Program spans, launches {correlation: (ts, tid)} and device events of
    one traced window; `owners[i]` lists the indices in `spans` of device
    event i's spans (None where its launch is missing)."""
    spans: list
    launches: dict
    events: list
    owners: list = field(default_factory=list)

    def count(self, prefix: str) -> int:
        """Spans whose name starts with `prefix` (a full name counts itself)."""
        return sum(1 for s in self.spans if s.name.startswith(prefix))

    def names_of(self, i: int) -> list[str]:
        return [self.spans[j].name for j in self.owners[i] or ()]

    def seconds(self, keep) -> float:
        """Device seconds of the events whose span names `keep` accepts."""
        return sum(e.dur for i, e in enumerate(self.events)
                   if self.owners[i] is not None and keep(self.names_of(i))) / 1e6

    def unmatched_s(self) -> float:
        return sum(e.dur for i, e in enumerate(self.events) if self.owners[i] is None) / 1e6

    def device_s(self) -> float:
        return sum(e.dur for e in self.events) / 1e6


def read_spans(path: str) -> SpanTrace:
    with open(path) as fp:
        events = [e for e in json.load(fp)["traceEvents"] if e.get("ph") == "X"]
    spans = [Span(e["name"], e.get("tid"), float(e["ts"]), float(e["dur"])) for e in events
             if e.get("cat") == "user_annotation" and e["name"].startswith(PREFIX)]
    launches = {e["args"]["correlation"]: (float(e["ts"]), e.get("tid")) for e in events
                if e.get("cat") in LAUNCH_CATEGORIES and "correlation" in e.get("args", {})}
    device = [DeviceEvent(e["name"], float(e["ts"]), float(e["dur"]),
                          e.get("args", {}).get("correlation"),
                          e.get("args", {}).get("stream", e.get("tid"))) for e in events
              if e.get("cat") in DEVICE_CATEGORIES]
    st = SpanTrace(spans, launches, device)
    st.owners = _owners(st)
    return st


def _owners(st: SpanTrace) -> list:
    """Each device event's spans: those open on its launch's thread at the
    launch, and the any-thread spans open then."""
    by_tid = collections.defaultdict(list)
    for j, s in enumerate(st.spans):
        by_tid[s.tid].append(j)
    wide = sorted((j for j, s in enumerate(st.spans) if s.name.startswith(ANY_THREAD)),
                  key=lambda j: st.spans[j].ts)
    launch_owners = {}
    launches_by_tid = collections.defaultdict(list)
    for corr, (ts, tid) in st.launches.items():
        launches_by_tid[tid].append((ts, corr))
    for tid, launches in launches_by_tid.items():
        order = sorted(by_tid.get(tid, ()), key=lambda j: (st.spans[j].ts, -st.spans[j].dur))
        stack, k = [], 0
        for ts, corr in sorted(launches):
            while k < len(order) and st.spans[order[k]].ts <= ts:
                stack.append(order[k])
                k += 1
            stack = [j for j in stack if st.spans[j].end >= ts]
            launch_owners[corr] = (tid, list(stack))
    starts = [st.spans[j].ts for j in wide]
    out = []
    for e in st.events:
        found = launch_owners.get(e.correlation)
        if found is None:
            out.append(None)
            continue
        tid, mine = found
        ts = st.launches[e.correlation][0]
        extra = [j for j in wide[:bisect.bisect_right(starts, ts)]
                 if st.spans[j].end >= ts and st.spans[j].tid != tid]
        out.append(mine + extra)
    return out


# -- readings ---------------------------------------------------------------------


def _is_fir(names: list[str]) -> bool:
    return (any(n.startswith("lvg.upfirdn2d.") for n in names)
            and not any(n.startswith("lvg.filtered_lrelu.") for n in names))


def upfirdn2d_s(st: SpanTrace) -> float:
    """Device seconds inside an `lvg.upfirdn2d.*` span and outside every
    `lvg.filtered_lrelu.*` span: forward, backward (`.bwd`) and double
    backward (`.bwd.bwd`)."""
    return st.seconds(_is_fir)


def _inside(inner: Span, outer: Span) -> bool:
    return inner.tid == outer.tid and outer.ts <= inner.ts and inner.end <= outer.end


def filtered_lrelu_s(st: SpanTrace, layers: list[str]) -> tuple[float, int]:
    """(device seconds, forward calls) of `lvg.filtered_lrelu.*` inside the
    spans `lvg.layer.<name>` of `layers`, whatever path each call took."""
    wanted = {f"lvg.layer.{name}" for name in layers}

    def keep(names):
        return (any(n in wanted for n in names)
                and any(n.startswith("lvg.filtered_lrelu.") for n in names))

    layer_spans = [s for s in st.spans if s.name in wanted]
    calls = sum(1 for s in st.spans if s.name.startswith("lvg.filtered_lrelu.")
                and not s.name.endswith(".bwd") and any(_inside(s, o) for o in layer_spans))
    return st.seconds(keep), calls


def _busy(events) -> list[tuple[float, float]]:
    """The union of the events' intervals, as sorted [start, end) runs."""
    runs = []
    for e in sorted(events, key=lambda e: e.ts):
        if runs and e.ts <= runs[-1][1]:
            runs[-1][1] = max(runs[-1][1], e.ts + e.dur)
        else:
            runs.append([e.ts, e.ts + e.dur])
    return [tuple(r) for r in runs]


def union_s(st: SpanTrace, keep) -> float:
    return sum(b - a for a, b in _busy([e for i, e in enumerate(st.events)
                                       if st.owners[i] is not None
                                       and keep(st.names_of(i))])) / 1e6


def launch_waits(st: SpanTrace) -> list[tuple[float, str]]:
    """(seconds, innermost span on the launching thread) of each idle gap
    between device events whose closing event was launched after the gap
    opened; where that thread has no span open (autograd's thread outside
    an op's backward), `- in <innermost phase>`. Gaps closed by an
    unmatched event are left out."""
    runs = _busy(st.events)
    first = collections.defaultdict(list)
    for i, e in enumerate(st.events):
        first[e.ts].append(i)
    out = []
    for (_, opened), (closed, _) in zip(runs, runs[1:]):
        matched = [i for i in first[closed] if st.owners[i] is not None]
        if not matched:
            continue
        i = min(matched, key=lambda i: st.launches[st.events[i].correlation][0])
        corr = st.events[i].correlation
        launched, tid = st.launches[corr]
        if launched > opened:
            where = _innermost(st, i, lambda s: s.tid == tid)
            if where == "-":
                where = f"- in {_innermost(st, i, lambda s: s.name.startswith(ANY_THREAD))}"
            out.append(((closed - opened) / 1e6, where))
    return out


def idle_between_s(st: SpanTrace) -> float:
    """Seconds between the first and last device event in which nothing ran."""
    runs = _busy(st.events)
    return sum(b[0] - a[1] for a, b in zip(runs, runs[1:])) / 1e6


def _innermost(st: SpanTrace, i: int, keep) -> str:
    """The latest-opened span of event i's that `keep` accepts, or "-"."""
    found = [st.spans[j] for j in st.owners[i] if keep(st.spans[j])]
    return max(found, key=lambda s: s.ts).name if found else "-"


def fir_sites(st: SpanTrace) -> dict[str, float]:
    """FIR device seconds (as `upfirdn2d_s`) by pass (`fwd`, `bwd`, R1's
    `bwd.bwd`), call site (the innermost model span on the launching thread:
    `lvg.prep_cond`, `lvg.D`, `lvg.augment`, `lvg.layer.*`, ...; autograd's
    thread has none) and phase (the innermost `lvg.segment`, `lvg.update_*`
    or `lvg.adam`)."""
    out = collections.Counter()
    for i, e in enumerate(st.events):
        if st.owners[i] is None or not _is_fir(st.names_of(i)):
            continue
        fir = _innermost(st, i, lambda s: s.name.startswith("lvg.upfirdn2d."))
        tid = st.launches[e.correlation][1]
        site = _innermost(st, i, lambda s: s.tid == tid and not s.name.startswith(
            ("lvg.upfirdn2d.", "lvg.filtered_lrelu.") + ANY_THREAD))
        if site.startswith("lvg.layer."):
            site = "lvg.layer.*"
        phase = _innermost(st, i, lambda s: s.name.startswith(ANY_THREAD))
        kind = fir.split(".", 3)[3] if fir.count(".") > 2 else "fwd"
        out[f"{kind} {site} in {phase}"] += e.dur / 1e6
    return dict(out)


def readings(st: SpanTrace, kind: str, ctx: dict, layers: list[str]) -> dict:
    """The per-layer quantities of a cell of `kind` (`stream` or `train`):
    none where the trace holds no program span or no device event, a
    per-segment one None without `lvg.segment` spans, the R1 one None
    without an `lvg.update_r1` span, and `filtered_lrelu_roofline.gen` None
    unless the kernel layers' calls number `ctx["k1_expected"]`."""
    if not st.spans or not st.events:
        return {}
    waits = sum(seconds for seconds, _ in launch_waits(st))
    if kind == "stream":
        segments = st.count("lvg.segment")
        seconds, calls = filtered_lrelu_s(st, layers)
        return {"upfirdn2d_ms.gen": 1e3 * upfirdn2d_s(st) / segments if segments else None,
                "filtered_lrelu_roofline.gen": (100.0 * ctx["k1_bound_s"] / seconds
                                                if calls == ctx["k1_expected"] and seconds > 0
                                                else None),
                "launch_wait_ms.gen": 1e3 * waits / segments if segments else None}
    r1 = st.count("lvg.update_r1")
    return {"upfirdn2d_ms.train": 1e3 * upfirdn2d_s(st) / ctx["steps"],
            "launch_wait_ms.train": 1e3 * waits / ctx["steps"],
            "update_r1_device_ms.train": (
                1e3 * union_s(st, lambda names: "lvg.update_r1" in names) / r1 if r1 else None)}


def report(st: SpanTrace) -> dict:
    """The per-span tables: FIR ms by call site, `filtered_lrelu` ms by its
    innermost span (path, forward or backward), the depthwise kernels' ms by
    the op span they ran in, launch-wait ms by the span that issued the late
    launch, the unmatched share, and totals."""
    waits = collections.Counter()
    gaps = launch_waits(st)
    for seconds, where in gaps:
        waits[where] += seconds
    paths, depthwise = collections.Counter(), collections.Counter()
    for i, e in enumerate(st.events):
        if st.owners[i] is None:
            continue
        path = _innermost(st, i, lambda s: s.name.startswith("lvg.filtered_lrelu."))
        if path != "-":
            paths[path] += e.dur / 1e6
        if categorize(e.name) == "depthwise conv":
            op = path if path != "-" else _innermost(
                st, i, lambda s: s.name.startswith("lvg.upfirdn2d."))
            depthwise[op] += e.dur / 1e6
    return {"fir_ms_by_site": {k: 1e3 * v for k, v in sorted(fir_sites(st).items())},
            "filtered_lrelu_ms_by_span": {k: 1e3 * v for k, v in sorted(paths.items())},
            "depthwise_ms_by_op": {k: 1e3 * v for k, v in sorted(depthwise.items())},
            "launch_wait_ms_by_span": {k: 1e3 * v for k, v in waits.most_common(20)},
            "launch_waits": len(gaps),
            "idle_between_ms": 1e3 * idle_between_s(st),
            "device_ms": 1e3 * st.device_s(),
            "unmatched_share": st.unmatched_s() / st.device_s() if st.events else None,
            "unmatched_by_name": dict(collections.Counter(
                e.name[:60] for i, e in enumerate(st.events) if st.owners[i] is None
            ).most_common(8)),
            "spans": dict(collections.Counter(
                s.name if not s.name.startswith("lvg.layer.") else "lvg.layer.*"
                for s in st.spans))}


# -- a cell's traced window, once more -------------------------------------------------


def cell_report(run) -> dict:
    """Set up `run`'s cell, take its traced run's context (the accepted
    readers' numbers with it), then trace the same window once more with
    its chrome trace kept, and read it."""
    import os
    import tempfile
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from . import flops
    from . import run as bench_run
    from .common import sync

    _, per_layer = bench_run.benchmark_entries(run.cell["name"])
    driver = bench_run.driver_for(run.traffic)(run)
    driver.setup()
    ctx = driver.traced()
    accepted = {m["name"]: bench_run.metric_reader(m["name"])(ctx) for m in per_layer}
    kind = run.traffic["driver"]
    if kind == "stream":
        net = driver.G.SG3.synthesis
        kernel = flops.hand_kernel_layers(driver.G)
        layers = [n for n, layer in zip(net.layer_names, net.layers)
                  if any(layer is k for k in kernel)]

        def fn():
            driver.spans = True
            driver.window(float("inf"), max_segments=run.traffic["trace_segments"])
            driver.spans = False
    else:
        layers = []

        def fn():
            for i in range(run.traffic["trace_steps"]):
                driver._cycle(i, spans=True)

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if run.device.type == "cuda" else [])
    with profile(activities=activities) as prof:
        start = time.perf_counter()
        fn()
        sync(run.device)
        window_s = time.perf_counter() - start
    fd, path = tempfile.mkstemp(suffix=".json", prefix="spans-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        st = read_spans(path)
    finally:
        os.remove(path)
    return {"workload": run.cell["name"], "seed": run.seed,
            "card": torch.cuda.get_device_name(run.device) if run.device.type == "cuda"
            else "cpu", "window_s": window_s, "readings": readings(st, kind, ctx, layers),
            "accepted": accepted, "accepted_window_s": ctx["trace"].window_s, **report(st)}


def main(argv=None) -> int:
    import argparse
    import sys

    import torch

    from . import run as bench_run
    from .common import Run

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell, config, traffic = bench_run.load_cell(args.workload)
    run = Run(cell=cell, config=config, traffic=traffic,
              seed=args.seed, seconds=0.0, trace=True, device=torch.device("cuda", 0))
    print(json.dumps(cell_report(run)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
