"""Multiband parametric EQ — port of ``st_ito_tpu/ops/eq.py``'s
``parametric_eq_sos``, ``parametric_eq`` and ``parametric_eq_scan``: low
shelf -> N peaking bands -> high shelf, the cascade's response built on the
rFFT grid and applied with one FFT (``ops/iir.py apply_iir_fsm``), or run
exactly sample by sample (the golden-test path)."""

from __future__ import annotations

import torch

from st_ito_torch.ops.iir import apply_iir_fsm, biquad_coeffs, biquad_scan


def parametric_eq_sos(sample_rate: float, low_shelf_gain_db,
                      low_shelf_cutoff_freq, low_shelf_q_factor,
                      band_gains_db, band_cutoff_freqs, band_q_factors,
                      high_shelf_gain_db, high_shelf_cutoff_freq,
                      high_shelf_q_factor):
    """Design the full cascade. Band args have shape (..., n_bands); shelf
    args shape (...,). Returns (b, a) of shape (..., n_bands + 2, 3)."""
    b_ls, a_ls = biquad_coeffs(low_shelf_gain_db, low_shelf_cutoff_freq,
                               low_shelf_q_factor, sample_rate, "low_shelf")
    b_bd, a_bd = biquad_coeffs(band_gains_db, band_cutoff_freqs,
                               band_q_factors, sample_rate, "peaking")
    b_hs, a_hs = biquad_coeffs(high_shelf_gain_db, high_shelf_cutoff_freq,
                               high_shelf_q_factor, sample_rate, "high_shelf")
    b = torch.cat([b_ls[..., None, :], b_bd, b_hs[..., None, :]], dim=-2)
    a = torch.cat([a_ls[..., None, :], a_bd, a_hs[..., None, :]], dim=-2)
    return b, a


def parametric_eq(x: torch.Tensor, sample_rate: float, low_shelf_gain_db=0.0,
                  low_shelf_cutoff_freq=80.0, low_shelf_q_factor=0.707,
                  band_gains_db=None, band_cutoff_freqs=None,
                  band_q_factors=None, high_shelf_gain_db=0.0,
                  high_shelf_cutoff_freq=1000.0, high_shelf_q_factor=0.707,
                  pad: int = 8192) -> torch.Tensor:
    """Apply the EQ cascade to x (..., T) by frequency sampling."""
    if band_gains_db is None:
        band_gains_db = torch.zeros(1)
        band_cutoff_freqs = torch.full((1,), 300.0)
        band_q_factors = torch.full((1,), 0.707)
    b, a = parametric_eq_sos(
        sample_rate, low_shelf_gain_db, low_shelf_cutoff_freq,
        low_shelf_q_factor, band_gains_db, band_cutoff_freqs, band_q_factors,
        high_shelf_gain_db, high_shelf_cutoff_freq, high_shelf_q_factor)
    return apply_iir_fsm(x, b.to(x.device), a.to(x.device), pad=pad)


def parametric_eq_scan(x: torch.Tensor, sample_rate: float,
                       **kwargs) -> torch.Tensor:
    """The same cascade as ``parametric_eq``, exactly: per-sample TDF-II
    sections one after another (``ops/iir.py biquad_scan``). Golden-test
    path only."""
    b, a = parametric_eq_sos(
        sample_rate,
        kwargs.get("low_shelf_gain_db", 0.0),
        kwargs.get("low_shelf_cutoff_freq", 80.0),
        kwargs.get("low_shelf_q_factor", 0.707),
        torch.as_tensor(kwargs.get("band_gains_db", [0.0])),
        torch.as_tensor(kwargs.get("band_cutoff_freqs", [300.0])),
        torch.as_tensor(kwargs.get("band_q_factors", [0.707])),
        kwargs.get("high_shelf_gain_db", 0.0),
        kwargs.get("high_shelf_cutoff_freq", 1000.0),
        kwargs.get("high_shelf_q_factor", 0.707))
    for i in range(b.shape[-2]):
        x = biquad_scan(x, b[..., i, :], a[..., i, :])
    return x
