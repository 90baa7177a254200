"""update_D_ms.lres: host-clock milliseconds per cycle of the D phase,
the device synchronised before and after each `update_D` call of the
traced run's untraced cycles."""


def read(ctx):
    return ctx.get("phase_ms", {}).get("update_D")
