"""K6 (the lone biquad-cascade EQ) and K8 (the lone compressor ballistics).

Ports of ``st_ito_tpu/ops/pallas/scan.py:133 biquad_cascade_pallas`` and
``:810 ballistics_pallas``. The CUDA kernels are ``st_ito_torch/csrc/scan.cu``;
beside them here are their plain PyTorch versions, Python loops over T on
(lanes,) tensors in the kernels' order of operations. The wrappers
``biquad_cascade`` and ``ballistics`` run the plain version for a CPU tensor
and the kernel for any other: on a CUDA tensor they launch the kernel or
raise.
"""

from __future__ import annotations

import ctypes
import math

import torch

from st_ito_torch.ops.kernels import _build

# Kernel launches since the last reset, by kernel (chip_smoke.py reads them).
launches = {"biquad_cascade": 0, "ballistics": 0}

# the section count K6 is instantiated for (the basic parametric EQ)
KERNEL_SECTIONS = 6


def _check_cuda(*tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError("scan kernels take contiguous float32 CUDA "
                             f"tensors, got {t.device} {t.dtype}")
        if t.device != dev:
            raise ValueError("scan kernel inputs lie on different devices")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ------------------------------------------------------------------ K6


def biquad_cascade_inputs(x, b, a, active=None, shared_lead_shape=None):
    """The kernel's inputs as ``scan.py:140-156`` prepares them.

    Returns (x_in, vec, num_sections, with_active, shared_channels,
    lead_shape): x_in is (lanes, T), or the shared (C, T) input when
    shared_channels = C > 0 (lane b*C + c reads x[c]); vec is the
    (5*S [+ 1], lanes) float32 table of per-lane coefficients and, with a
    bypass mask, the mask."""
    if shared_lead_shape is not None:
        lead_shape = tuple(shared_lead_shape)
        if x.ndim != 2 or x.shape[0] != lead_shape[-1]:
            raise ValueError(f"shared input {tuple(x.shape)} does not match "
                             f"lead shape {lead_shape}")
    else:
        lead_shape = tuple(x.shape[:-1])
    T = x.shape[-1]
    lead = math.prod(lead_shape)
    S = b.shape[-2]
    b = b.to(torch.float32).expand(lead_shape + b.shape[-2:]).reshape(lead, S, 3)
    a = a.to(torch.float32).expand(lead_shape + a.shape[-2:]).reshape(lead, S, 3)
    rows = []
    for s in range(S):
        rows += [b[:, s, 0], b[:, s, 1], b[:, s, 2], a[:, s, 1], a[:, s, 2]]
    if active is not None:
        rows.append(torch.as_tensor(active, dtype=torch.float32,
                                    device=x.device).expand(lead_shape)
                    .reshape(lead))
    vec = torch.stack(rows).contiguous()
    if shared_lead_shape is not None:
        x_in, shared_channels = x.to(torch.float32).contiguous(), x.shape[0]
    else:
        x_in = x.to(torch.float32).reshape(lead, T).contiguous()
        shared_channels = 0
    return x_in, vec, S, active is not None, shared_channels, lead_shape


def biquad_cascade_plain(x_in, vec, num_sections: int, with_active: bool,
                         shared_channels: int) -> torch.Tensor:
    """Plain PyTorch version of K6: the same operations in the same order,
    one time step at a time over all lanes. Returns (lanes, T)."""
    S = num_sections
    lanes = vec.shape[1]
    if shared_channels:
        x_in = x_in[torch.arange(lanes, device=x_in.device) % shared_channels]
    co = [[vec[5 * s + j] for j in range(5)] for s in range(S)]
    act = vec[5 * S] if with_active else None
    st = [[torch.zeros(lanes, dtype=torch.float32, device=x_in.device)
           for _ in range(2)] for _ in range(S)]
    cols = []
    for xin in x_in.unbind(-1):
        v = xin
        for s in range(S):
            b0, b1, b2, a1, a2 = co[s]
            s1, s2 = st[s]
            y = b0 * v + s1
            st[s] = [b1 * v - a1 * y + s2, b2 * v - a2 * y]
            v = y
        if act is not None:
            v = act * v + (1.0 - act) * xin
        cols.append(v)
    return torch.stack(cols, dim=1)


def biquad_cascade_cuda(x_in, vec, num_sections: int, with_active: bool,
                        shared_channels: int) -> torch.Tensor:
    """Launch K6 on the current stream. Returns (lanes, T)."""
    lib = _build.load("scan")
    _check_cuda(x_in, vec)
    lanes = vec.shape[1]
    T = x_in.shape[-1]
    if num_sections != KERNEL_SECTIONS:
        raise ValueError(f"the biquad cascade kernel is built for "
                         f"{KERNEL_SECTIONS} sections, got {num_sections}")
    if vec.shape[0] != 5 * num_sections + int(with_active):
        raise ValueError(f"vec has {vec.shape[0]} rows, expected "
                         f"{5 * num_sections + int(with_active)}")
    if shared_channels == 0 and x_in.shape[0] != lanes:
        raise ValueError(f"x has {x_in.shape[0]} lanes, vec {lanes}")
    out = torch.empty((lanes, T), dtype=torch.float32, device=x_in.device)
    fn = lib.biquad_cascade_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x_in.data_ptr(), shared_channels, vec.data_ptr(), out.data_ptr(),
             lanes, T, num_sections, int(with_active), _stream(x_in))
    if err != 0:
        raise RuntimeError(f"biquad cascade kernel launch failed: CUDA error "
                           f"{err}")
    launches["biquad_cascade"] += 1
    return out


def biquad_cascade(x, b, a, active=None, shared_lead_shape=None):
    """Exact serial biquad cascade over the last axis, parallel over the
    leading dims. x: (..., T), or the population-shared (C, T) input with
    ``shared_lead_shape=(B, C)``; b, a: (..., S, 3) with a0 = 1, broadcast
    against the leading dims; ``active``: optional float bypass mask
    broadcastable to them (1.0 = filter on), blended at write time.
    Returns (*lead_shape, T) float32."""
    x_in, vec, S, with_active, shared, lead_shape = biquad_cascade_inputs(
        x, b, a, active, shared_lead_shape)
    if x.device.type == "cpu":
        out = biquad_cascade_plain(x_in, vec, S, with_active, shared)
    else:
        out = biquad_cascade_cuda(x_in, vec, S, with_active, shared)
    return out.reshape(*lead_shape, x.shape[-1])


# ------------------------------------------------------------------ K8


def ballistics_inputs(c, alpha_attack, alpha_release):
    """(c_in (lanes, T), vec (2, lanes) = [aa; ar], lead_shape)."""
    lead_shape = tuple(c.shape[:-1])
    lead = math.prod(lead_shape)

    def vec(v):
        return torch.as_tensor(v, dtype=torch.float32, device=c.device) \
            .expand(lead_shape).reshape(lead)

    c_in = c.to(torch.float32).reshape(lead, c.shape[-1]).contiguous()
    return c_in, torch.stack([vec(alpha_attack), vec(alpha_release)]) \
        .contiguous(), lead_shape


def ballistics_plain(c_in, vec) -> torch.Tensor:
    """Plain PyTorch version of K8: the decoupled detector one time step at
    a time over all lanes. Returns (lanes, T)."""
    aa, ar = vec[0], vec[1]
    y1 = torch.zeros(c_in.shape[0], dtype=torch.float32, device=c_in.device)
    g = torch.zeros_like(y1)
    out = []
    for ct in c_in.unbind(-1):
        y1 = torch.minimum(ct, ar * y1 + (1.0 - ar) * ct)
        g = aa * g + (1.0 - aa) * y1
        out.append(g)
    return torch.stack(out, dim=1)


def ballistics_cuda(c_in, vec) -> torch.Tensor:
    """Launch K8 on the current stream. Returns (lanes, T)."""
    lib = _build.load("scan")
    _check_cuda(c_in, vec)
    lanes, T = c_in.shape
    if vec.shape != (2, lanes):
        raise ValueError(f"vec is {tuple(vec.shape)}, expected (2, {lanes})")
    out = torch.empty((lanes, T), dtype=torch.float32, device=c_in.device)
    fn = lib.ballistics_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(c_in.data_ptr(), vec.data_ptr(), out.data_ptr(), lanes, T,
             _stream(c_in))
    if err != 0:
        raise RuntimeError(f"ballistics kernel launch failed: CUDA error "
                           f"{err}")
    launches["ballistics"] += 1
    return out


def ballistics(c, alpha_attack, alpha_release):
    """The decoupled attack/release detector over the last axis of c
    (..., T), the gain computer's output in dB; alpha_attack and
    alpha_release broadcast to c's leading dims. Returns c's shape,
    float32."""
    c_in, vec, lead_shape = ballistics_inputs(c, alpha_attack, alpha_release)
    if c.device.type == "cpu":
        out = ballistics_plain(c_in, vec)
    else:
        out = ballistics_cuda(c_in, vec)
    return out.reshape(*lead_shape, c.shape[-1])
