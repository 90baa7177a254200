"""flrelu_f32_share.gen: the share of the traced device busy time spent in
the program's f32 filtered_lrelu kernels (symbols holding `flrelu_f32_`:
the f32 head layers L0-L2 on the kernel route), in percent of
`Trace.busy_s`. Nothing when none ran, as where the heads take the composed
path."""

STEM = "flrelu_f32_"


def read(ctx):
    tr = ctx["trace"]
    seconds = tr.seconds_by(lambda name: STEM in name).get(True, 0.0)
    busy = tr.busy_s()
    if seconds <= 0 or busy <= 0:
        return None
    return 100.0 * seconds / busy
