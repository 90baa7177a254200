"""r1_device_ms.lres: device milliseconds per R1 phase, the union of the
device intervals under the program's `lvg.update_r1` spans (work launched
on any thread while one is open). Nothing unless the program's `ops.conv`
call counters show R1's double backward running input and weight gradients
through it."""

from h100_bench import spans


def read(ctx):
    st, calls = ctx.get("spans"), ctx.get("r1_conv_calls", {})
    if st is None or not calls.get("input_grad_calls") or not calls.get("weight_grad_calls"):
        return None
    phases = st.count("lvg.update_r1")
    seconds = spans.union_s(st, lambda names: "lvg.update_r1" in names)
    return 1e3 * seconds / phases if phases and seconds > 0 else None
