"""K4, the inverse FFT that unpacks the stereo pair and truncates to T
(``csrc/mega_fft.cu``): 5 n log2 n operations a candidate; bytes: the
spectra (B, 2, F) complex read, the output (B, 2, T) written."""

import math

from portbench.counts.common import candidates_per_launch, fft_size


def per_launch(ctx, rec, launches):
    T, n = ctx["traffic"]["samples"], fft_size(ctx)
    F = n // 2 + 1
    B = candidates_per_launch(ctx, rec, launches)
    return 5 * n * math.log2(n) * B, 4 * (2 * B * T + 4 * B * F)
