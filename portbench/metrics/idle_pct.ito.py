"""The share of the traced window in which no operation ran on the device
(``torch.profiler``), in the ITO cells."""


def read(ctx, rec):
    tr = rec.get("trace")
    if not tr or "jobs" not in rec or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
