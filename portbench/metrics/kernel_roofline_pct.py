"""The port's hand-written kernels in the window: the sum of each launch's
least time (the larger of its operations over 67e12 FLOP/s and its bytes
over 3.35e12 B/s, counted from its shapes by ``counts/<kernel>.py``) over
the sum of their device time in the trace (``torch.profiler``, by kernel
name)."""

FP32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def read(ctx, rec):
    tr = rec.get("trace")
    launches = rec.get("launches", {})
    if not tr or not any(launches.values()) or not rec.get("generations"):
        return None
    from portbench.core.trace import port_kernel_s

    device_s = port_kernel_s(tr)
    if device_s <= 0:
        return None
    least = 0.0
    for kernel, n in launches.items():
        if n:
            ops, nbytes = ctx.count(kernel).per_launch(ctx, rec, n)
            least += n * max(ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
    return 100.0 * least / device_s
