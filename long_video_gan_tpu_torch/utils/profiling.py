"""Tracing and profiling helpers on one NVIDIA GPU.

Counterpart of `long_video_gan_tpu/utils/profiling.py`, on `torch.profiler`
in place of `jax.profiler`:

  * `trace(dir)`: a context manager around `torch.profiler.profile` (CPU and
    CUDA activities) that writes a chrome trace under `dir` on exit;
  * `trace_op_times(dir)`: [(kernel name, device seconds)] from the newest
    chrome trace there; `categorize_op` and `print_op_summary` group them;
  * `annotate(name)`: `torch.profiler.record_function`, a named span;
  * `device_memory_stats()`, `peak_device_memory_gb()`: per-device
    allocated and peak bytes (empty on a CPU run); `host_memory_gb()`: RSS;
  * `module_summary(module, *args)`: per-submodule parameters and output
    shapes to depth 2 (the counterpart of `nn.tabulate`);
  * `gpu_name_and_power_limit()`: the card as `nvidia-smi` names it.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import json
import os
import subprocess
import time
from typing import Optional

import torch


def annotate(name: str):
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU and, where the build has it, CUDA activity) and
    write its chrome trace to `log_dir/trace-<ns>.json`; yields the
    directory."""
    from torch.profiler import ProfilerActivity, profile, supported_activities

    os.makedirs(log_dir, exist_ok=True)
    activities = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
                  if a in supported_activities()]
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{time.time_ns()}.json"))


# Chrome-trace categories of work on the device.
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_op_times(trace_dir: str) -> list[tuple[str, float]]:
    """[(kernel name, device seconds)], one row per device event of the
    newest chrome trace under `trace_dir` (kernels, copies and sets). Raises
    if the trace holds no kernel: a CPU-only trace, or one CUPTI left
    empty."""
    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.json"), recursive=True),
                   key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no chrome trace written under {trace_dir}")
    with open(paths[-1]) as fp:
        events = json.load(fp)["traceEvents"]
    rows = [(e["name"], e["dur"] / 1e6) for e in events
            if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATEGORIES]
    if not any(e.get("ph") == "X" and e.get("cat") == "kernel" for e in events):
        raise RuntimeError(f"{paths[-1]} holds no device kernel (a CPU-only trace, or the "
                           f"profiler saw no CUDA activity)")
    return rows


# The port's own kernels by symbol, most specific first
# (`csrc/filtered_lrelu_{tc,fused_tc,exact_tc,fwd,bwd}.cu`).
_PORT_KERNELS = (
    ("filtered_lrelu_fused_fwd", "K3a filtered_lrelu fused fwd"),
    ("filtered_lrelu_fused_bwd", "K3b filtered_lrelu fused bwd"),
    ("filtered_lrelu_exact", "K4 filtered_lrelu exact"),
    ("filtered_lrelu_polyphase", "K5 filtered_lrelu polyphase"),
    ("filtered_lrelu_fwd", "K1 filtered_lrelu fwd"),
    ("filtered_lrelu_bwd", "K2 filtered_lrelu bwd"),
)


def categorize_op(name: str) -> str:
    """Coarse category of a CUDA kernel name for trace summaries: the
    port's K1-K5 by symbol, then the library kernels by family (cuDNN's
    convolution kernels by their pass, PyTorch's own kernels before the
    bare word "conv", which their template arguments may contain)."""
    n = name.lower()
    for symbol, category in _PORT_KERNELS:
        if symbol in n:
            return category
    for category, marks in (
            ("nccl", ("nccl",)),
            ("memcpy/memset", ("memcpy", "memset")),
            ("optimizer", ("multi_tensor_apply",)),
            ("depthwise conv", ("depthwise",)),
            ("conv (cuDNN/CUTLASS)", ("fprop", "dgrad", "wgrad", "implicit_gemm",
                                      "implicit_convolve", "winograd")),
            ("gemm (cuBLAS/CUTLASS)", ("cublas",)),
            ("relayout (transpose/copy/cat)", ("nchwtonhwc", "nhwctonchw", "transpose", "copy",
                                               "catarray", "concat")),
            ("gather/scatter", ("gather", "scatter", "index")),
            ("reduce", ("reduce_kernel", "norm", "softmax")),
            ("elementwise", ("elementwise",)),
            ("conv (cuDNN/CUTLASS)", ("conv",)),
            ("gemm (cuBLAS/CUTLASS)", ("gemm", "cutlass", "xmma"))):
        if any(m in n for m in marks):
            return category
    return "other"


def print_op_summary(rows, top: int = 30) -> dict[str, tuple[float, int]]:
    """Grouped and top-N tables of `trace_op_times` rows: device ms, share
    and launches per category and per kernel. Returns {category: (seconds,
    launches)}."""
    per_op = collections.Counter()
    per_cat = collections.Counter()
    op_n = collections.Counter()
    cat_n = collections.Counter()
    for name, dur in rows:
        cat = categorize_op(name)
        per_op[name] += dur
        per_cat[cat] += dur
        op_n[name] += 1
        cat_n[cat] += 1
    total = sum(per_op.values()) or 1e-12

    print(f"\ndevice time total = {total * 1e3:.1f} ms\n")
    print(f"{'category':<32}{'ms':>10}{'%':>7}{'launches':>10}")
    for cat, dur in per_cat.most_common():
        print(f"{cat:<32}{dur * 1e3:>10.2f}{100 * dur / total:>6.1f}%{cat_n[cat]:>10}")
    print(f"\ntop {top} kernels by total device time:")
    print(f"{'kernel':<72}{'ms':>10}{'%':>7}{'launches':>10}")
    for name, dur in per_op.most_common(top):
        print(f"{name[:71]:<72}{dur * 1e3:>10.2f}{100 * dur / total:>6.1f}%{op_n[name]:>10}")
    return {cat: (dur, cat_n[cat]) for cat, dur in per_cat.items()}


def device_memory_stats() -> dict:
    """Per-device allocated, peak and total bytes of this process (an empty
    dict without a CUDA device)."""
    if not torch.cuda.is_available():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = dict(
            bytes_in_use=stats.get("allocated_bytes.all.current", 0),
            peak_bytes_in_use=stats.get("allocated_bytes.all.peak", 0),
            bytes_limit=torch.cuda.get_device_properties(i).total_memory,
        )
    return out


def peak_device_memory_gb() -> float:
    stats = device_memory_stats()
    if not stats:
        return 0.0
    return max(s["peak_bytes_in_use"] for s in stats.values()) / 2**30


def host_memory_gb() -> float:
    try:
        import psutil

        return psutil.Process(os.getpid()).memory_info().rss / 2**30
    except ImportError:
        try:
            with open("/proc/self/statm") as fp:
                pages = int(fp.read().split()[1])
            return pages * os.sysconf("SC_PAGE_SIZE") / 2**30
        except OSError:
            return 0.0


def gpu_name_and_power_limit(device=None) -> Optional[str]:
    """`nvidia-smi --query-gpu=name,power.limit` of `device`'s card (the
    current one by default); None on the CPU."""
    device = torch.device(device if device is not None else
                          ("cuda" if torch.cuda.is_available() else "cpu"))
    if device.type != "cuda":
        return None
    index = device.index if device.index is not None else torch.cuda.current_device()
    return subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def module_rows(module: torch.nn.Module, *args, depth: int = 2, **kwargs) -> list[dict]:
    """One row per submodule to `depth` (the module itself first, named ""):
    its dotted name, class, parameter count (itself and below) and output
    shape in one forward call on `args` (None where the call did not reach
    it)."""
    rows, hooks = {}, []
    for name, sub in module.named_modules():
        if name and name.count(".") >= depth:
            continue
        rows[name] = dict(name=name, type=type(sub).__name__, output=None,
                          params=sum(p.numel() for p in sub.parameters()))

        def hook(_, __, out, name=name):
            if rows[name]["output"] is None:
                rows[name]["output"] = _shapes(out)

        hooks.append(sub.register_forward_hook(hook))
    try:
        with torch.no_grad():
            module(*args, **kwargs)
    finally:
        for h in hooks:
            h.remove()
    return list(rows.values())


def _shapes(out):
    if isinstance(out, torch.Tensor):
        return tuple(out.shape)
    if isinstance(out, (tuple, list)):
        return [_shapes(o) for o in out]
    return type(out).__name__


def module_summary(module: torch.nn.Module, *args, **kwargs) -> str:
    """Architecture table of `module_rows`: per-submodule parameters and
    output shapes to depth 2."""
    lines = [f"{'module':<48}{'type':<28}{'params':>14}  output"]
    for r in module_rows(module, *args, **kwargs):
        lines.append(f"{(r['name'] or '(top)')[:47]:<48}{r['type'][:27]:<28}"
                     f"{r['params']:>14,}  {r['output']}")
    return "\n".join(lines)
