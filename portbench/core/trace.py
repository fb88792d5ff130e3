"""The device trace of a window: ``torch.profiler`` over CPU and CUDA, and
its reduction to what the per-layer readers and the breakdown read.

``reduce`` gives, from the profiler's raw events: each device operation's
summed seconds and count by name, the union of device busy intervals
(``busy_s``), the traced window (``window_s``), and the device's idle gaps
summed by the innermost host operation that was running at each gap's
middle (``gaps``)."""

from __future__ import annotations

import bisect
import contextlib
import re

import torch

# the port's hand-written kernels (st_ito_torch/csrc, all in an anonymous
# namespace or scancore::): a device operation whose name holds one of
# these in such a namespace is one of them
PORT_KERNELS = (
    "pass_b_kernel", "pass_c_kernel", "pass_d_kernel", "release_carry_kernel",
    "attack_carry_kernel", "fft_fused_kernel", "forward_kernel",
    "inverse_kernel", "packed_response_kernel", "recurrence_rest_pass",
    "recurrence_carry", "recurrence_out_pass", "detector_release_pass",
    "detector_release_carry", "detector_attack_pass", "detector_attack_carry",
    "detector_out_pass", "linear_state_pass", "linear_state_carry",
    "linear_state_out_pass")
_PORT_RE = re.compile(r"(anonymous namespace\)::|_GLOBAL__N_\w*?\d+|scancore"
                      r"(::|\d+))(" + "|".join(PORT_KERNELS) + r")\b")
GAP_MIN_NS = 10_000  # gaps shorter than this are left unlabelled
WINDOW = "portbench.window"  # the host range that marks the window
PROFILER_OWN = ("Activity Buffer",)  # the profiler's own host events


def is_port_kernel(name: str) -> bool:
    return _PORT_RE.search(name) is not None


@contextlib.contextmanager
def profiled(enabled: bool):
    """Yields the profiler (or None when not enabled)."""
    if not enabled:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        yield prof


def _ns(ev, what):
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, f"{what}_us")() * 1000)


def _events(prof):
    return prof.profiler.kineto_results.events()


def reduce(prof) -> dict:
    """{"ops": {name: [s, count]}, "busy_s", "window_s", "gaps":
    {label: s}}. The window is the host range named ``WINDOW``, else from
    the first to the last device event."""
    dev, host = [], []
    for ev in _events(prof):
        start, dur, name = _ns(ev, "start"), _ns(ev, "duration"), ev.name()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if name != WINDOW:  # the window's own range, mirrored on the device
                dev.append((start, start + dur, name))
        elif not name.startswith(PROFILER_OWN):
            host.append((start, start + dur, name))
    if not dev:
        return {"ops": {}, "busy_s": 0.0, "window_s": 0.0, "gaps": {}}
    dev.sort()
    marks = [(s, e) for s, e, n in host if n == WINDOW]
    lo, hi = marks[0] if marks else (dev[0][0], max(d[1] for d in dev))
    host = [h for h in host if h[2] != WINDOW]
    ops: dict[str, list] = {}
    for s, e, name in dev:
        rec = ops.setdefault(name, [0.0, 0])
        rec[0] += (e - s) * 1e-9
        rec[1] += 1
    busy, gaps = 0, []
    cur_s, cur_e = None, lo
    for s, e, _ in dev:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            if s - cur_e >= GAP_MIN_NS:
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        busy += cur_e - cur_s
    if hi - cur_e >= GAP_MIN_NS:
        gaps.append((cur_e, hi))
    return {"ops": ops, "busy_s": busy * 1e-9, "window_s": (hi - lo) * 1e-9,
            "gaps": _label_gaps(gaps, host)}


def _label_gaps(gaps, host) -> dict:
    """Idle seconds by the innermost host operation running at each gap's
    middle ("host code" where none was recorded)."""
    host.sort()
    starts = [h[0] for h in host]
    out: dict[str, float] = {}
    for s, e in gaps:
        mid = (s + e) // 2
        i = bisect.bisect_right(starts, mid)
        best = None
        for j in range(i - 1, max(i - 4000, -1), -1):
            hs, he, name = host[j]
            if he >= mid and (best is None or he - hs < best[1] - best[0]):
                best = (hs, he, name)
        label = "host code" if best is None else best[2]
        out[label] = out.get(label, 0.0) + (e - s) * 1e-9
    return out


def breakdown(red: dict, top: int = 10) -> dict:
    ops = sorted(((n, v[0]) for n, v in red["ops"].items()),
                 key=lambda kv: -kv[1])[:top]
    gaps = sorted(red["gaps"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}


def port_kernel_s(red: dict) -> float:
    return sum(v[0] for n, v in red["ops"].items() if is_port_kernel(n))
