"""The 95th percentile of the port's ``generation`` span (``phase_timer``,
CUDA events from before ``ask`` to the end of ``tell`` in ``run_es``'s host
loop) over the window's generations."""

import numpy as np


def read(ctx, rec):
    spans = rec.get("spans", {}).get("generation")
    if not spans:
        return None
    return float(np.percentile(spans, 95))
