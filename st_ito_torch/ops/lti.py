"""The fused-LTI group for a stereo population: packed forward FFT -> K9 ->
inverse FFT. Port of ``st_ito_tpu/ops/pallas/packed_response.py:318
packed_lti_apply_rp`` in its ``fft_mode="mx"`` form, where the JAX package
runs XLA's four-step matmul FFT (``ops/mxfft.py fft_mx``) around the
kernel; here that FFT is ``torch.fft`` (cuFFT on the card)."""

from __future__ import annotations

import torch

from st_ito_torch.ops.kernels.packed_response import packed_response_apply
from st_ito_torch.utils import phase_timer


def packed_lti_apply_rp(x: torch.Tensor, stages, n: int,
                        tables: dict) -> torch.Tensor:
    """x: (B, 2, T) float32. Packs z = x_L + i x_R, takes Z = FFT_n(z),
    hands the half grids Zlo = Z[:, :F] and Zrev[k] = Z[(n-k) mod n] to
    K9, reassembles Y = [Ylo, flip(Yhig[:, 1:n/2])] and returns
    (Re, Im) of IFFT_n(Y)[:, :T] as the (B, 2, T) stereo output.
    ``torch.fft.ifft`` already scales by 1/n."""
    B, C, T = x.shape
    if C != 2:
        raise ValueError("the fused rp path is stereo-only")
    F = n // 2 + 1
    dev = x.device
    with phase_timer.span("fft_fwd", dev):
        Z = torch.fft.fft(torch.complex(x[:, 0], x[:, 1]), n=n, dim=-1)
        Zrev = torch.cat([Z[:, :1], torch.flip(Z[:, n // 2:], (-1,))], -1)
        ZrL, ZiL = Z[:, :F].real.contiguous(), Z[:, :F].imag.contiguous()
        del Z
        ZrR, ZiR = Zrev.real.contiguous(), Zrev.imag.contiguous()
        del Zrev
    with phase_timer.span("k9", dev):
        YloR, YloI, YhiR, YhiI = packed_response_apply(ZrL, ZiL, ZrR, ZiR,
                                                       stages, tables)
    del ZrL, ZiL, ZrR, ZiR
    with phase_timer.span("fft_inv", dev):
        Y = torch.complex(
            torch.cat([YloR, torch.flip(YhiR[:, 1:n // 2], (-1,))], -1),
            torch.cat([YloI, torch.flip(YhiI[:, 1:n // 2], (-1,))], -1))
        del YloR, YloI, YhiR, YhiI
        y = torch.fft.ifft(Y, n=n, dim=-1)[:, :T]
        del Y
        return torch.stack([y.real, y.imag], dim=1)
