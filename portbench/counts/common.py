"""Shapes shared by the kernels' counts: how many candidates one launch
covers, from the window's launches and its fitness calls, and the LTI
group's FFT size."""

import json
import os


def candidates_per_launch(ctx, rec, launches: int, per_call: int = 1) -> float:
    """Each fitness call launches the kernel ``per_call`` times for each
    sub-batch of its population; the sub-batches are equal."""
    return ctx["traffic"]["popsize"] * rec["generations"] * per_call / launches


def fft_size(ctx) -> int:
    T = ctx["traffic"]["samples"]
    pad = min(T, 10 * ctx["config"]["sample_rate"]) if ctx["traffic"][
        "chunked"] else T
    return 1 << (T + pad - 1).bit_length()


def chain_effects(ctx) -> list:
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chains", f"{ctx['traffic']['chain']}.json")
    with open(path) as f:
        return [e["effect"] for e in json.load(f).values()]
