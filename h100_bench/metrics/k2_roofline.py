"""k2_roofline: K2's share of its roofline in the traced cycles.

The bound of every K2 launch (`flops.bound_s` of the input gradient on the
reference's bf16 layers, at G's micro-batch frames), over the device
seconds of the kernels that `trace.categorize` names K2, in percent.
Nothing when K2 did not run once per bf16 layer and G micro-batch (the
program's own launch counter)."""


def read(ctx):
    seconds = ctx["trace"].category_s("K2 filtered_lrelu bwd")
    if seconds <= 0 or ctx.get("k2_launches") != ctx.get("k2_expected"):
        return None
    return 100.0 * ctx["k2_bound_s"] / seconds
