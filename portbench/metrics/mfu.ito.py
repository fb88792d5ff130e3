"""Cnn14 FLOPs of every item the window embedded (mid and side of each
candidate, of each chunk in the long-audio mode, and of each job's
target), over the window's seconds, over the H100's dense bfloat16 peak
(989e12 FLOP/s: the fitness's Cnn14 runs in bfloat16)."""

PEAK = 989e12


def read(ctx, rec):
    if "jobs" not in rec or ctx["device"].type != "cuda":
        return None
    cfg, traffic = ctx["config"], ctx["traffic"]
    cnn14 = ctx.count("cnn14")
    chunk = min(cfg["crop_len"], traffic["samples"])
    chunks = ((traffic["samples"] - chunk) // chunk + 1
              if traffic["chunked"] else 1)
    items = 0
    for job in rec["jobs"]:
        items += 2 * chunks * (traffic["popsize"] * job["generations"] + 1)
    flops = items * cnn14.forward_flops(cfg["encoder"], chunk)
    return 100.0 * flops / rec["window_s"] / PEAK
