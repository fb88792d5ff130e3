"""Differentiable processors on normalized [0, 1] parameters, batched —
port of ``st_ito_tpu/proc.py``.

Every function takes ``audio (bs, chs, T)`` and ``params (bs, P)`` with
params in [0, 1], with the reference's parameter counts and ranges: the
simple processor (15-parameter EQ -> compressor, 21 parameters) and the
complex one (EQ(18) -> compressor(6, lookahead 512) -> distortion(1) ->
noise-shaped reverb(25) -> gain(1), 51 parameters), the one ``run_autodiff``
optimises without a chain. Plain PyTorch under autograd, batched by
broadcasting over ``bs`` (the JAX package ``vmap``s the compressor and the
reverb per example): the EQ by frequency sampling (``ops/iir.py
apply_iir_fsm``), the compressor op by op with its parallel ballistics
(``ops/dynamics.py compressor``, no kernel), the reverb by FFT convolution
(``ops/reverb.py noise_shaped_reverb``).
"""

from __future__ import annotations

import torch

from st_ito_torch.ops import dynamics as _dyn
from st_ito_torch.ops import eq as _eq
from st_ito_torch.ops import reverb as _rev
from st_ito_torch.ops.iir import apply_iir_fsm

NUM_GAIN_PARAMS = 1
NUM_DISTORTION_PARAMS = 1
NUM_REVERB_PARAMS = 25
NUM_COMPRESSOR_PARAMS = 6
NUM_PARAMETRIC_EQ_PARAMS = 18
NUM_PARAMETRIC_EQ_15_PARAMS = 15
NUM_SIMPLE_PARAMS = NUM_PARAMETRIC_EQ_15_PARAMS + NUM_COMPRESSOR_PARAMS  # 21
NUM_COMPLEX_PARAMS = (
    NUM_PARAMETRIC_EQ_PARAMS
    + NUM_COMPRESSOR_PARAMS
    + NUM_DISTORTION_PARAMS
    + NUM_REVERB_PARAMS
    + NUM_GAIN_PARAMS
)  # 51


def denormalize(p: torch.Tensor, min_val: float, max_val: float):
    """[0, 1] -> [min_val, max_val]."""
    return p * (max_val - min_val) + min_val


def _col(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]  # (bs,) -> (bs, 1, 1) over (chs, T)


def apply_gain(audio: torch.Tensor, params: torch.Tensor, sample_rate: int):
    """params (bs, 1): gain_db in [-48, 48]."""
    gain_db = denormalize(params[:, 0], -48.0, 48.0)
    return audio * _col(10.0 ** (gain_db / 20.0))


def apply_distortion(audio: torch.Tensor, params: torch.Tensor,
                     sample_rate: int):
    """params (bs, 1): drive_db in [0, 48]."""
    drive_db = denormalize(params[:, 0], 0.0, 48.0)
    return torch.tanh(audio * _col(10.0 ** (drive_db / 20.0)))


def apply_compressor(audio: torch.Tensor, params: torch.Tensor,
                     sample_rate: int):
    """params (bs, 6): threshold [-60, 0] dB, ratio [1, 20], attack [0.1,
    250] ms, release [10, 2000] ms, knee [1, 24] dB, makeup [0, 24] dB;
    linked channels, lookahead 512."""
    th, ratio, atk, rel, knee, makeup = (
        _col(denormalize(params[:, i], lo, hi)) for i, (lo, hi) in enumerate(
            ((-60.0, 0.0), (1.0, 20.0), (0.1, 250.0), (10.0, 2000.0),
             (1.0, 24.0), (0.0, 24.0))))
    return _dyn.compressor(
        audio, sample_rate, threshold_db=th, ratio=ratio, attack_ms=atk,
        release_ms=rel, knee_db=knee, makeup_gain_db=makeup,
        lookahead_samples=512)


def apply_reverb(audio: torch.Tensor, params: torch.Tensor, sample_rate: int):
    """params (bs, 25): 12 band gains, 12 band decays, mix, all [0, 1]."""
    return _rev.noise_shaped_reverb(audio, sample_rate, params[:, 0:12],
                                    params[:, 12:24], params[:, 24])


def _eq_section_params(params: torch.Tensor, idx: int):
    g = denormalize(params[:, 3 * idx + 0], -18.0, 18.0)
    f = denormalize(params[:, 3 * idx + 1], 20.0, 20000.0)
    q = denormalize(params[:, 3 * idx + 2], 0.1, 10.0)
    return g, f, q


def _apply_eq_sections(audio, params, sample_rate, num_bands):
    ls_g, ls_f, ls_q = _eq_section_params(params, 0)
    band = [_eq_section_params(params, 1 + i) for i in range(num_bands)]
    hs_g, hs_f, hs_q = _eq_section_params(params, 1 + num_bands)
    b, a = _eq.parametric_eq_sos(
        sample_rate, ls_g, ls_f, ls_q,
        torch.stack([g for g, _, _ in band], dim=-1),
        torch.stack([f for _, f, _ in band], dim=-1),
        torch.stack([q for _, _, q in band], dim=-1),
        hs_g, hs_f, hs_q)
    # b, a: (bs, sections, 3); audio (bs, chs, T): a channel broadcast dim
    return apply_iir_fsm(audio, b[:, None], a[:, None])


def apply_parametric_eq(audio: torch.Tensor, params: torch.Tensor,
                        sample_rate: int):
    """params (bs, 18): 6 sections x (gain, freq, q): low shelf, 4 bands,
    high shelf."""
    return _apply_eq_sections(audio, params, sample_rate, num_bands=4)


def apply_parametric_eq_15(audio: torch.Tensor, params: torch.Tensor,
                           sample_rate: int):
    """The simple processor's 15-parameter EQ: six sections, as the
    reference's, where params[12:15] drive both band 3 and the high
    shelf."""
    params18 = torch.cat([params, params[:, 12:15]], dim=-1)
    return _apply_eq_sections(audio, params18, sample_rate, num_bands=4)


def apply_simple_autodiff_processor(audio: torch.Tensor, params: torch.Tensor,
                                    sample_rate: int, *args):
    """15-parameter EQ -> 6-parameter compressor (21 parameters)."""
    eq_p = params[:, :NUM_PARAMETRIC_EQ_15_PARAMS]
    comp_p = params[:, NUM_PARAMETRIC_EQ_15_PARAMS:]
    audio = apply_parametric_eq_15(audio, eq_p, sample_rate)
    return apply_compressor(audio, comp_p, sample_rate)


def apply_complex_autodiff_processor(audio: torch.Tensor,
                                     params: torch.Tensor, sample_rate: int,
                                     *args):
    """EQ(18) -> compressor(6) -> distortion(1) -> reverb(25) -> gain(1),
    51 parameters."""
    i0 = NUM_PARAMETRIC_EQ_PARAMS
    i1 = i0 + NUM_COMPRESSOR_PARAMS
    i2 = i1 + NUM_DISTORTION_PARAMS
    i3 = i2 + NUM_REVERB_PARAMS
    audio = apply_parametric_eq(audio, params[:, :i0], sample_rate)
    audio = apply_compressor(audio, params[:, i0:i1], sample_rate)
    audio = apply_distortion(audio, params[:, i1:i2], sample_rate)
    audio = apply_reverb(audio, params[:, i2:i3], sample_rate)
    return apply_gain(audio, params[:, i3:], sample_rate)
