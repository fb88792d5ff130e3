"""Device selection, WAV I/O and the batch helpers (the port's own copies of
``st_ito_tpu/utils.py``'s ``load_audio`` / ``save_audio``, on
``scipy.io.wavfile``, and of its ``apply_fade_in``, ``batch_peak_normalize``
and ``batch_loudness_normalize``) and opt-in per-phase CUDA-event timing."""

from __future__ import annotations

import contextlib
from collections import defaultdict

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. The port defaults to the card and
    never moves to the CPU on its own: without a card it raises, and the
    caller must ask for ``device="cpu"`` explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "st_ito_torch entry points run on a CUDA device by default and "
            "none is available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def load_audio(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (audio (C, T) float32 in [-1, 1], sample_rate)."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 1:
        data = data[None, :]
    else:
        data = data.T  # (T, C) -> (C, T)
    return np.ascontiguousarray(data), int(sr)


def save_audio(path: str, audio, sample_rate: int) -> None:
    """Write (C, T) float32 audio as 16-bit WAV."""
    from scipy.io import wavfile

    if isinstance(audio, torch.Tensor):
        audio = audio.detach().cpu().numpy()
    audio = np.asarray(audio, np.float32)
    if audio.ndim == 1:
        audio = audio[None, :]
    audio = np.clip(audio, -1.0, 1.0)
    wavfile.write(path, sample_rate, (audio.T * 32767.0).astype(np.int16))


def apply_fade_in(x: torch.Tensor, num_samples: int = 16384) -> torch.Tensor:
    from st_ito_torch.ops.waveshape import fade_in

    return fade_in(x, num_samples)


def batch_peak_normalize(x: torch.Tensor) -> torch.Tensor:
    """Each item of a batch (B, ...) over its own peak."""
    peak = torch.amax(x.abs(), dim=tuple(range(1, x.ndim)), keepdim=True)
    return x / torch.clamp_min(peak, 1e-8)


def batch_loudness_normalize(x: torch.Tensor, sample_rate: int,
                             target_lufs: float) -> torch.Tensor:
    """Each item of x (..., C, T) gained to ``target_lufs`` integrated
    loudness (``ops/loudness.py``)."""
    from st_ito_torch.ops.loudness import loudness_normalize

    return loudness_normalize(x, sample_rate, target_lufs)


class PhaseTimer:
    """Named spans timed with CUDA events.

    Off by default: ``span`` then returns at once and records nothing. When
    enabled (``chip_smoke.py`` does so around the timed ES block), each span
    on a CUDA device records an event pair on the current stream without
    synchronising; ``read_ms`` synchronises once and returns each name's
    span times in the order they ran. Spans on the CPU are not recorded:
    there is no device time to read."""

    def __init__(self):
        self.enabled = False
        self._events: dict[str, list] = defaultdict(list)

    def reset(self, enabled: bool) -> None:
        self.enabled = enabled
        self._events.clear()

    @contextlib.contextmanager
    def span(self, name: str, device: torch.device):
        if not self.enabled or device.type != "cuda":
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            self._events[name].append((start, end))

    def read_ms(self) -> dict[str, list[float]]:
        torch.cuda.synchronize()
        return {name: [s.elapsed_time(e) for s, e in pairs]
                for name, pairs in self._events.items()}


# the main path's spans: ask, k1 or k6, the LTI group's (k3, k4 in mega2; k5,
# k2, k4 in mega; fft_fwd, k9, fft_inv in mx; k10_fwd, k9, k10_inv in fused),
# the nonlinear stages' (k7, k8, multiband_fft), embed, tell
phase_timer = PhaseTimer()
