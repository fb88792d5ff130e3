"""Cnn14 FLOPs of the window's train steps over its seconds, over the
H100's float32 peak outside the tensor cores (67e12 FLOP/s: the trainer
runs float32 with TF32 off). Each example embeds four items (mid and side
of its input and of its output); each takes a forward, and each whose
gradient the step takes twice that again for the backward."""

PEAK = 67e12


def read(ctx, rec):
    if "steps" not in rec or ctx["device"].type != "cuda":
        return None
    cfg = ctx["config"]
    fwd = ctx.count("cnn14").forward_flops(cfg["encoder"], cfg["length"])
    per_example = 4 * fwd + rec["grad_items_per_example"] * 2 * fwd
    return 100.0 * rec["examples"] * per_example / rec["window_s"] / PEAK
