"""The port's ``render`` span (``phase_timer``, CUDA events around the
population renderer in the fitness), summed over the window and divided by
its generations (find_w0's included)."""


def read(ctx, rec):
    spans = rec.get("spans", {}).get("render")
    if not spans or not rec.get("generations"):
        return None
    return sum(spans) / rec["generations"]
