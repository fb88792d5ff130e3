"""Process start to the window's start: imports, the kernels' load (or
build), weights, inputs or shards, warm-up."""


def read(ctx, rec):
    return rec["setup_s"]
