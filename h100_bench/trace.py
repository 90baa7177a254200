"""Reading a traced window: the profiler's device events and what they sum to.

`profile(fn)` runs `fn` under `torch.profiler` (CPU and CUDA activity),
writes the chrome trace under TMPDIR, reads it and deletes it. `Trace`
holds the device events (kernels, copies and sets) and answers the readers
of `h100_bench/metrics/`: the union of busy intervals, seconds by kernel
category (`categorize`, a copy of the program's
`utils/profiling.categorize_op`), and the breakdown the result line carries.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

# The program's own kernels by symbol, most specific first.
PORT_KERNELS = (
    ("filtered_lrelu_fused_fwd", "K3a filtered_lrelu fused fwd"),
    ("filtered_lrelu_fused_bwd", "K3b filtered_lrelu fused bwd"),
    ("filtered_lrelu_exact", "K4 filtered_lrelu exact"),
    ("filtered_lrelu_polyphase", "K5 filtered_lrelu polyphase"),
    ("filtered_lrelu_fwd", "K1 filtered_lrelu fwd"),
    ("filtered_lrelu_bwd", "K2 filtered_lrelu bwd"),
)
LIBRARY_KERNELS = (
    ("nccl", ("nccl",)),
    ("memcpy/memset", ("memcpy", "memset")),
    ("optimizer", ("multi_tensor_apply",)),
    ("depthwise conv", ("depthwise",)),
    ("conv (cuDNN/CUTLASS)", ("fprop", "dgrad", "wgrad", "implicit_gemm", "implicit_convolve",
                              "winograd")),
    ("gemm (cuBLAS/CUTLASS)", ("cublas",)),
    ("relayout (transpose/copy/cat)", ("nchwtonhwc", "nhwctonchw", "transpose", "copy",
                                       "catarray", "concat")),
    ("gather/scatter", ("gather", "scatter", "index")),
    ("reduce", ("reduce_kernel", "norm", "softmax")),
    ("elementwise", ("elementwise",)),
    ("conv (cuDNN/CUTLASS)", ("conv",)),
    ("gemm (cuBLAS/CUTLASS)", ("gemm", "cutlass", "xmma")),
)


def categorize(name: str) -> str:
    """Coarse category of a device event's name."""
    n = name.lower()
    for symbol, category in PORT_KERNELS:
        if symbol in n:
            return category
    for category, marks in LIBRARY_KERNELS:
        if any(m in n for m in marks):
            return category
    return "other"


@dataclass
class Trace:
    """Device events [(name, start us, duration us)] of a traced window of
    `window_s` seconds on the host clock, and the host spans [(name, start
    us, duration us)] of the CPU side."""
    events: list
    window_s: float
    host_spans: list = field(default_factory=list)

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device: the union of
        the device events' intervals."""
        busy, end = 0.0, float("-inf")
        for _, ts, dur in sorted(self.events, key=lambda e: e[1]):
            if ts >= end:
                busy += dur
                end = ts + dur
            elif ts + dur > end:
                busy += ts + dur - end
                end = ts + dur
        return busy / 1e6

    def seconds_by(self, key: Callable[[str], str]) -> dict[str, float]:
        out = collections.Counter()
        for name, _, dur in self.events:
            out[key(name)] += dur / 1e6
        return dict(out)

    def category_s(self, category: str) -> float:
        return self.seconds_by(categorize).get(category, 0.0)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps named by the host span that was open when each began."""
        by_op = collections.Counter()
        for name, _, dur in self.events:
            by_op[name[:120]] += dur / 1e6
        gaps = []
        end = None
        for _, ts, dur in sorted(self.events, key=lambda e: e[1]):
            if end is not None and ts > end:
                gaps.append((ts - end, end))
            end = ts + dur if end is None else max(end, ts + dur)
        gaps.sort(reverse=True)
        idle = []
        for gap, start in gaps[:top]:
            open_spans = [(s_ts, name) for name, s_ts, s_dur in self.host_spans
                          if s_ts <= start <= s_ts + s_dur]
            where = max(open_spans)[1] if open_spans else "host"
            idle.append([where[:120], gap / 1e6])
        return {"device_ops": [[k, v] for k, v in by_op.most_common(top)], "idle_gaps": idle}


def read_chrome_trace(path: str, window_s: float, span_prefix: str = "bench.") -> Trace:
    with open(path) as fp:
        events = json.load(fp)["traceEvents"]
    device = [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]
    spans = [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e["name"].startswith(span_prefix)]
    return Trace(device, window_s, spans)


def profile(fn: Callable[[], None]) -> Trace:
    """Run `fn` under torch.profiler and return its Trace; the window is the
    host clock around `fn`, which ends with the device synchronised."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - start
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return read_chrome_trace(path, window_s)
    finally:
        os.remove(path)
