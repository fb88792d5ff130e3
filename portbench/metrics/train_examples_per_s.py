"""Examples of all the window's train steps over the window's wall time
(host clock; each step ends in the fetch of its loss)."""


def read(ctx, rec):
    if "examples" not in rec:
        return None
    return rec["examples"] / rec["window_s"]
