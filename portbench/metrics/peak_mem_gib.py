"""``torch.cuda.max_memory_allocated()`` over the window (reset at its
start), in GiB."""


def read(ctx, rec):
    if not rec.get("peak_bytes"):
        return None
    return rec["peak_bytes"] / 2 ** 30
