"""The port's ``forward`` span (``phase_timer``, CUDA events around the
pretext loss's forward in ``train/param.py train_step``), summed over the
window and divided by its steps. Recorded while the profiler runs: in the
traced window alone; read on the card only, as the ITO driver reads its
spans."""


def read(ctx, rec):
    from st_ito_torch.utils import phase_timer

    if ctx["device"].type != "cuda":
        return None
    spans = phase_timer.read_ms().get("forward")
    if not spans or not rec.get("steps"):
        return None
    return sum(spans) / rec["steps"]
