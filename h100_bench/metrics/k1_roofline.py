"""k1_roofline: K1's share of its roofline in the traced window.

The bound of every K1 launch (`flops.bound_s` on the reference's bf16
layers: tap-exact operations at the dense bf16 peak or each map byte once
at 3.35 TB/s, the larger), over the device seconds of the kernels that
`trace.categorize` names K1, in percent. Nothing when K1 did not run once
per bf16 layer and segment (the program's own launch counter)."""


def read(ctx):
    seconds = ctx["trace"].category_s("K1 filtered_lrelu fwd")
    if seconds <= 0 or ctx.get("k1_launches") != ctx.get("k1_expected"):
        return None
    return 100.0 * ctx["k1_bound_s"] / seconds
