"""Candidate evaluations of all the window's jobs (find_w0's population
included) over the window's wall time (host clock; each job ends in a
synchronise)."""


def read(ctx, rec):
    if "evals" not in rec:
        return None
    return rec["evals"] / rec["window_s"]
