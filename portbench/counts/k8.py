"""K8, the decoupled attack/release detector scan (``csrc/scan.cu``): per
sample and lane 9 float32 operations (the release stage 5, the attack
stage 4); bytes: the gain computer's output read and the detector's
written. Every K8 of these chains is a linked detector (the multiband
compressor's three bands, the limiter, the gate), one lane a candidate."""

from portbench.counts.common import candidates_per_launch, chain_effects

OPS_PER_SAMPLE = 9
PER_STAGE = {"multiband_compressor": 3, "limiter": 1, "noise_gate": 1}


def per_launch(ctx, rec, launches):
    T = ctx["traffic"]["samples"]
    per_call = sum(PER_STAGE.get(e, 0) for e in chain_effects(ctx))
    lanes = candidates_per_launch(ctx, rec, launches, per_call)
    return OPS_PER_SAMPLE * lanes * T, 4 * 2 * lanes * T
