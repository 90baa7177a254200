"""G_temporal_ms.lres: device milliseconds per cycle under the program's
spans of G's six temporal blocks, `lvg.layer.temporal<i>` and their `.bwd`:
forward in every G call, backward in update_G. Nothing unless each span
opened once per G call and its `.bwd` once per G micro-batch of update_G."""

from h100_bench.drivers.train_lres import layer_ms

NAMES = [f"lvg.layer.temporal{i}" for i in range(6)]


def read(ctx):
    return layer_ms(ctx, NAMES)
