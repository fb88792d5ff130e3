"""The share of the window outside ``run_es``'s own ``time_elapsed``: each
job's target embed, fitness build and output render, summed over the
window's jobs, over the window."""


def read(ctx, rec):
    if "jobs" not in rec:
        return None
    outside = sum(j["wall_s"] - j["time_elapsed"] for j in rec["jobs"])
    return 100.0 * outside / rec["window_s"]
