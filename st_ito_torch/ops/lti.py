"""The fused-LTI group for a stereo population: packed forward FFT -> K9 ->
inverse FFT. Port of ``st_ito_tpu/ops/pallas/packed_response.py:318
packed_lti_apply_rp`` with its ``fft_impl`` switch: "mx", where the JAX
package runs XLA's four-step matmul FFT (``ops/mxfft.py fft_mx``) around the
kernel and the port ``torch.fft`` (cuFFT on the card), and "fused" (alias
"mx3"), where both transforms are K10 (``ops/kernels/fused_fft.py``) on the
shapes ``fused_fft.supported`` admits and ``torch.fft`` on any other."""

from __future__ import annotations

import torch

from st_ito_torch.ops.kernels import fused_fft
from st_ito_torch.ops.kernels.packed_response import packed_response_apply


def packed_lti_apply_rp(x: torch.Tensor, stages, n: int, tables: dict,
                        fft_impl: str = "mx") -> torch.Tensor:
    """x: (B, 2, T) float32. Packs z = x_L + i x_R, takes Z = FFT_n(z),
    hands the half grids Zlo = Z[:, :F] and Zrev[k] = Z[(n-k) mod n] to
    K9, reassembles Y = [Ylo, flip(Yhig[:, 1:n/2])] and returns
    (Re, Im) of IFFT_n(Y)[:, :T] / n as the (B, 2, T) stereo output."""
    B, C, T = x.shape
    if C != 2:
        raise ValueError("the fused rp path is stereo-only")
    if fft_impl not in ("mx", "fused", "mx3"):
        raise ValueError(f"fft_impl={fft_impl!r}: 'mx', 'fused' or 'mx3'")
    fused = fft_impl != "mx" and fused_fft.supported(n, T)
    F = n // 2 + 1
    if fused:
        # the channels read in place; a broadcast population input (the
        # group first in the chain) is written out once, as the mega paths
        # do
        x = x.contiguous()
        Zr, Zi = fused_fft.fft_fused(x[:, 0], x[:, 1], sign=-1, n=n)
    else:
        Z = torch.fft.fft(torch.complex(x[:, 0], x[:, 1]), n=n, dim=-1)
        Zr, Zi = Z.real, Z.imag
        del Z
    ZrL, ZiL = Zr[:, :F].contiguous(), Zi[:, :F].contiguous()
    # Zrev[k] = Z[(n-k) mod n] for k in [0, n/2]: [Z0, Z_{n-1}, .., Z_{n/2}]
    ZrR, ZiR = (torch.cat([v[:, :1], torch.flip(v[:, n // 2:], (-1,))], -1)
                for v in (Zr, Zi))
    del Zr, Zi
    YloR, YloI, YhiR, YhiI = packed_response_apply(ZrL, ZiL, ZrR, ZiR,
                                                   stages, tables)
    del ZrL, ZiL, ZrR, ZiR
    Yr = torch.cat([YloR, torch.flip(YhiR[:, 1:n // 2], (-1,))], -1)
    Yi = torch.cat([YloI, torch.flip(YhiI[:, 1:n // 2], (-1,))], -1)
    del YloR, YloI, YhiR, YhiI
    if fused:
        yr, yi = fused_fft.fft_fused(Yr, Yi, sign=1, n=n, out_len=T)
        return torch.stack([yr, yi], dim=1) * (1.0 / n)
    y = torch.fft.ifft(torch.complex(Yr, Yi), n=n, dim=-1)[:, :T]
    return torch.stack([y.real, y.imag], dim=1)
