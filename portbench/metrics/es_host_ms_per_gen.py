"""The port's ``ask`` and ``tell`` spans (``phase_timer``: host spans in
``run_es``'s host loop, device spans in the device-resident loop), summed
over the window and divided by the number of ``ask`` spans."""


def read(ctx, rec):
    spans = rec.get("spans", {})
    ask, tell = spans.get("ask"), spans.get("tell")
    if not ask or not tell:
        return None
    return (sum(ask) + sum(tell)) / len(ask)
