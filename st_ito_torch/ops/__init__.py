"""The effects' DSP in plain PyTorch — port of ``st_ito_tpu/ops``, with the
JAX package's public names: biquad design and application, the EQ, the
dynamics, waveshaping, the modulated delays, the reverbs, stereo and
loudness helpers, the multiband compressor, the resampler and the STFT
features. Physical (denormalized) parameter units; the [0, 1] layer lives
in ``st_ito_torch.proc`` and ``st_ito_torch.chain``. Beside them: the
fused-LTI FFT glue (``ops/lti.py``) and the hand-written kernels' wrappers
(``ops/kernels``)."""

from st_ito_torch.ops.iir import (
    apply_iir_fsm,
    biquad_coeffs,
    biquad_scan,
    fft_filt,
    freqz,
    lfilter_scan,
    linear_recurrence,
    next_pow2,
    one_pole_smooth,
)
from st_ito_torch.ops.eq import (parametric_eq, parametric_eq_scan,
                                 parametric_eq_sos)
from st_ito_torch.ops.dynamics import (
    ballistics_parallel,
    ballistics_scan,
    compressor,
    gain_computer,
    limiter,
    noise_gate,
)
from st_ito_torch.ops.waveshape import (
    distortion,
    fade_in,
    flip_phase,
    gain,
    peak_normalize,
)
from st_ito_torch.ops.delay import chorus, feedback_delay, phaser
from st_ito_torch.ops.reverb import (freeverb, noise_shaped_ir,
                                     noise_shaped_reverb)
from st_ito_torch.ops.stereo import (
    from_mid_side,
    mono_to_stereo,
    pan,
    stereo_widener,
    swap_channels,
    to_mid_side,
)
from st_ito_torch.ops.loudness import (
    integrated_loudness,
    k_weight,
    loudness_normalize,
)
from st_ito_torch.ops.multiband import multiband_compressor, split_bands
from st_ito_torch.ops.resample import resample
from st_ito_torch.ops.stft import (
    frame_signal,
    hann_window,
    logmel,
    mel_filterbank,
    mfcc,
    power_to_db,
    spectral_centroid,
    spectrogram,
    stft,
)

__all__ = [
    # iir
    "apply_iir_fsm", "biquad_coeffs", "biquad_scan", "fft_filt", "freqz",
    "lfilter_scan", "linear_recurrence", "next_pow2", "one_pole_smooth",
    # eq
    "parametric_eq", "parametric_eq_scan", "parametric_eq_sos",
    # dynamics
    "ballistics_parallel", "ballistics_scan", "compressor", "gain_computer",
    "limiter", "noise_gate",
    # waveshape
    "distortion", "fade_in", "flip_phase", "gain", "peak_normalize",
    # delay
    "chorus", "feedback_delay", "phaser",
    # reverb
    "freeverb", "noise_shaped_ir", "noise_shaped_reverb",
    # stereo
    "from_mid_side", "mono_to_stereo", "pan", "stereo_widener",
    "swap_channels", "to_mid_side",
    # loudness
    "integrated_loudness", "k_weight", "loudness_normalize",
    # multiband
    "multiband_compressor", "split_bands",
    # resample
    "resample",
    # stft
    "frame_signal", "hann_window", "logmel", "mel_filterbank", "mfcc",
    "power_to_db", "spectral_centroid", "spectrogram", "stft",
]
