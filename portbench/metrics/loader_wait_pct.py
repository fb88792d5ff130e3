"""The port's ``loader_wait`` span (``phase_timer``, a host span around
``prefetch_batches``' wait for the next batch), summed over the window,
over the window, in %. Recorded while the profiler runs: in the traced
window alone; read on the card only, as the ITO driver reads its spans."""


def read(ctx, rec):
    from st_ito_torch.utils import phase_timer

    if ctx["device"].type != "cuda":
        return None
    spans = phase_timer.read_ms().get("loader_wait")
    if not spans or not rec.get("window_s"):
        return None
    return 100.0 * sum(spans) * 1e-3 / rec["window_s"]
