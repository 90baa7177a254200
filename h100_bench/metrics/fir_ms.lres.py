"""fir_ms.lres: device milliseconds per cycle in the kernels that
`trace.categorize` names "depthwise conv" (upfirdn2d's FIRs)."""


def read(ctx):
    seconds = ctx["trace"].category_s("depthwise conv")
    return 1e3 * seconds / ctx["steps"] if seconds > 0 else None
