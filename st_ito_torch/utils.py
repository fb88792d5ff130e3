"""Device selection, WAV I/O and the batch helpers (the port's own copies of
``st_ito_tpu/utils.py``'s ``load_audio`` / ``save_audio``, on
``scipy.io.wavfile``, and of its ``apply_fade_in``, ``batch_peak_normalize``
and ``batch_loudness_normalize``) and the port's named spans
(``phase_timer``)."""

from __future__ import annotations

import contextlib
import time
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


class _DeviceSpan:
    """A CUDA event pair on the current stream, recorded without
    synchronising."""

    __slots__ = ("pairs", "start")

    def __init__(self, pairs: list):
        self.pairs = pairs

    def __enter__(self):
        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record()

    def __exit__(self, *exc):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self.pairs.append((self.start, end))


class _HostSpan:
    """``perf_counter_ns`` around host-only work, inside a profiler range
    named ``st_ito.<name>``."""

    __slots__ = ("times", "range", "t0")

    def __init__(self, name: str, times: list):
        self.times = times
        self.range = torch.profiler.record_function(f"st_ito.{name}")

    def __enter__(self):
        self.range.__enter__()
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        self.times.append(time.perf_counter_ns() - self.t0)
        self.range.__exit__(*exc)


_NO_SPAN = contextlib.nullcontext()


class PhaseTimer:
    """Named spans of the port's work, of two kinds.

    - ``span(name, device)``: device work, timed by a CUDA event pair on
      the current stream. It opens no profiler range: the profiler mirrors
      a range that encloses kernels as a device event of the same name,
      which a trace would count as busy time. Not recorded on the CPU:
      there is no device time to read.
    - ``host_span(name)``: host-only work, timed by ``perf_counter_ns``
      and opened as the profiler range ``st_ito.<name>``, which labels the
      device's idle time in a trace. It must enclose no device work (no
      kernel launch, no copy), for the mirror above. Recorded on the CPU
      too.

    A span records while it is active: when ``enabled`` is set
    (``reset(True)``) or while a ``torch.profiler`` session runs.
    Otherwise both return one shared no-op context manager. ``read_ms``
    returns each name's times in ms in the order they ran, both kinds in
    one dict, synchronising once where there are device spans."""

    def __init__(self):
        self.enabled = False
        self._events: dict[str, list] = defaultdict(list)
        self._host_ns: dict[str, list] = defaultdict(list)

    def reset(self, enabled: bool) -> None:
        self.enabled = enabled
        self._events.clear()
        self._host_ns.clear()

    def _active(self) -> bool:
        return self.enabled or torch._C._autograd._profiler_enabled()

    def span(self, name: str, device: torch.device):
        if device.type != "cuda" or not self._active():
            return _NO_SPAN
        return _DeviceSpan(self._events[name])

    def host_span(self, name: str):
        if not self._active():
            return _NO_SPAN
        return _HostSpan(name, self._host_ns[name])

    def read_ms(self) -> dict[str, list[float]]:
        out = {name: [t * 1e-6 for t in ns]
               for name, ns in self._host_ns.items()}
        if self._events:
            torch.cuda.synchronize()
            for name, pairs in self._events.items():
                out.setdefault(name, []).extend(
                    s.elapsed_time(e) for s, e in pairs)
        return out


# the port's spans (PERF.md's span table): ask, tell and generation in
# run_es's host loop (ask and tell on the device in device_es.py's loop);
# render and embed in the fitness; h2d, forward, backward and optimizer in
# the pretext train step; loader_wait in prefetch_batches
phase_timer = PhaseTimer()
