"""mfu.gen: the streamed step's share of the card's dense bf16 peak.

Operations per hr frame (`flops.segment_flops` on the reference model's
layer plan: convolutions, matrix products and tap-exact FIRs, the same
whatever implements them) times the frames of the traced run's untraced
window, over that window's host-clock seconds and 989 TFLOP/s, in percent."""

from h100_bench.flops import PEAK_FLOPS_BF16


def read(ctx):
    if not ctx.get("frames") or ctx["host_s"] <= 0:
        return None
    return 100.0 * ctx["flops"] / ctx["host_s"] / PEAK_FLOPS_BF16
