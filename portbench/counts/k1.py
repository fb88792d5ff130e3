"""K1, the fused EQ -> compressor -> distortion scan (``csrc/eqcomp.cu``):
per sample and lane 94 float32 operations (6 biquads x 9, the EQ blend 4,
the gain computer 12, the ballistics 9, the gain 4, the compressor blend 4,
tanh distortion 3, its blend 4; a transcendental counts as one); bytes:
the output once and the population-shared input once."""

from portbench.counts.common import candidates_per_launch

OPS_PER_SAMPLE = 94


def per_launch(ctx, rec, launches):
    C, T = ctx["config"]["channels"], ctx["traffic"]["samples"]
    lanes = candidates_per_launch(ctx, rec, launches) * C
    return OPS_PER_SAMPLE * lanes * T, 4 * (lanes * T + C * T)
