"""The benchmark's clock around each ``next()`` on the loader
(``prefetch_batches`` over ``NpzShardDataset``), summed over the window,
over the window."""


def read(ctx, rec):
    if "data_wait_s" not in rec:
        return None
    return 100.0 * rec["data_wait_s"] / rec["window_s"]
