"""update_G_ms.lres: host-clock milliseconds per cycle of the G phase,
the device synchronised before and after each `update_G` call of the
traced run's untraced cycles."""


def read(ctx):
    return ctx.get("phase_ms", {}).get("update_G")
