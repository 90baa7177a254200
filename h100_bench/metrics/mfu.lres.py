"""mfu.lres: the model operations of the traced run's untraced cycles over
their host-clock seconds and the card's dense float32 peak (67 TFLOP/s: with
TF32 off no tensor core runs the convolutions), in percent. The operations
are the dense convolutions and matrix products of G and D, forward, input
and weight gradients and R1's double backward, counted on the reference
trainer on the meta device (`flops.DenseFlops`; the whole-output-filter
weight term of PyTorch's double backward counts as the weight gradient it
equals); FIRs and elementwise work are left out."""

from h100_bench.flops import PEAK_FLOPS_F32


def read(ctx):
    if not ctx.get("flops") or ctx["host_s"] <= 0:
        return None
    return 100.0 * ctx["flops"] / ctx["host_s"] / PEAK_FLOPS_F32
