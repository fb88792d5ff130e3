"""K6, the six-biquad EQ cascade scan (``csrc/scan.cu``): per sample and
lane 58 float32 operations (6 biquads x 9, the bypass blend 4); bytes:
the output once and the population-shared input once."""

from portbench.counts.common import candidates_per_launch

OPS_PER_SAMPLE = 58


def per_launch(ctx, rec, launches):
    C, T = ctx["config"]["channels"], ctx["traffic"]["samples"]
    lanes = candidates_per_launch(ctx, rec, launches) * C
    return OPS_PER_SAMPLE * lanes * T, 4 * (lanes * T + C * T)
