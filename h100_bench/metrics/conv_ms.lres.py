"""conv_ms.lres: device milliseconds per cycle in the kernels that
`trace.categorize` names "conv (cuDNN/CUTLASS)" (the dense convolutions)."""


def read(ctx):
    seconds = ctx["trace"].category_s("conv (cuDNN/CUTLASS)")
    return 1e3 * seconds / ctx["steps"] if seconds > 0 else None
