"""The port's ``embed`` span (``phase_timer``, CUDA events), summed over
the window and divided by its generations (find_w0's included)."""


def read(ctx, rec):
    spans = rec.get("spans", {}).get("embed")
    if not spans or not rec.get("generations"):
        return None
    return sum(spans) / rec["generations"]
