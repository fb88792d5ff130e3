"""K9, the packed delay + reverb response applied bin by bin
(``csrc/packed_response.cu``): per (candidate, bin) 290 float32 operations
(the delay's response 30, the reverb's 16 comb reciprocals at 9 and 40
more, two bypass blends 8, a monomix composition 24, the packed
coefficients 16, the packed apply 28); bytes: the spectra read and written
(8 floats a bin and candidate), the reverb's phasor table (38 rows of F)
and 9 parameters a candidate."""

from portbench.counts.common import candidates_per_launch, fft_size

OPS_PER_BIN = 30 + 16 * 9 + 40 + 8 + 24 + 16 + 28
TABLE_ROWS = 38


def per_launch(ctx, rec, launches):
    n = fft_size(ctx)
    F = n // 2 + 1
    B = candidates_per_launch(ctx, rec, launches)
    return OPS_PER_BIN * B * F, 4 * (8 * B * F + TABLE_ROWS * F + 9 * B)
