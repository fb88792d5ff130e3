"""K3, the forward FFT of the stereo pair packed as one complex signal
with the LTI group's response as its epilogue (``csrc/mega_fft.cu``):
5 n log2 n operations a candidate for the FFT plus K9's 290 a bin for the
response; bytes: the input (B, 2, T) read, the spectra (B, 2, F) complex
written, the reverb's phasor table (38 rows of F) and 9 parameters a
candidate read."""

import math

from portbench.counts.common import candidates_per_launch, fft_size
from portbench.counts.k9 import OPS_PER_BIN, TABLE_ROWS


def per_launch(ctx, rec, launches):
    T, n = ctx["traffic"]["samples"], fft_size(ctx)
    F = n // 2 + 1
    B = candidates_per_launch(ctx, rec, launches)
    ops = 5 * n * math.log2(n) * B + OPS_PER_BIN * B * F
    return ops, 4 * (2 * B * T + 4 * B * F + TABLE_ROWS * F + 9 * B)
