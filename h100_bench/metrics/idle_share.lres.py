"""idle_share.lres: the share of the traced cycles in which nothing ran on
the device: 1 - (union of kernel, copy and set intervals) / window, in
percent."""


def read(ctx):
    tr = ctx["trace"]
    if tr.window_s <= 0 or not tr.events:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
