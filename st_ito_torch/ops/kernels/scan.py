"""K6 (the lone biquad-cascade EQ), K7 (the whole unlinked compressor), K8
(the lone compressor ballistics) and K11 (the linear recurrence).

Ports of ``st_ito_tpu/ops/pallas/scan.py:133 biquad_cascade_pallas``,
``:436 compressor_fused_pallas``, ``:810 ballistics_pallas`` and
``:836 linear_recurrence_pallas``. The CUDA kernels are
``st_ito_torch/csrc/scan.cu``; beside them here are their plain PyTorch
versions, Python loops over T on (lanes,) tensors in the kernels' order of
operations (K7's gain computer and gain, which carry no state, are taken
over the whole (lanes, T) block around its loop). All four run as chunked
scans (``cascade_chunk_len``, ``detector_chunk_len`` and
``linrec_chunk_len`` pick the chunk): their carries round differently from
the serial chain, so they are held to their plain versions by the two
rules of ``chunked.gate_excess``, with a float64 run of the plain version
(``dtype=torch.float64``) as the witness, and the first chunk bit for bit.
The wrappers ``biquad_cascade``, ``compressor_fused``, ``ballistics`` and
``linear_recurrence`` run the plain version for a CPU tensor and the kernel
for any other: on a CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import math

import torch

from st_ito_torch.ops.kernels import _build, chunked

# Kernel launches since the last reset, by kernel (chip_smoke.py reads them).
launches = {"biquad_cascade": 0, "compressor_fused": 0, "ballistics": 0,
            "linear_recurrence": 0}

# the section count K6 is instantiated for (the basic parametric EQ)
KERNEL_SECTIONS = 6
# K6's carry table: the cascade's state, 2 values per section, per chunk
# and lane (csrc/scan_core.cuh run_chunked_linear)
CASCADE_ROWS = 2 * KERNEL_SECTIONS
# K7's and K8's carry table: the MinAffine (k, b, m) whose first row becomes
# y1, then g, per chunk and lane (csrc/scan_core.cuh DetectorTable)
DETECTOR_ROWS = 4
# K11's carry table: the chunk's end value from rest, which becomes y at its
# start, and the product of its coefficients (csrc/scan.cu RecurrenceTable)
RECURRENCE_ROWS = 2

_DB_PER_LOG = 20.0 / math.log(10.0)
_LN10_OVER_20 = math.log(10.0) / 20.0


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


def cascade_chunk_len(lanes: int, T: int) -> int:
    """K6's chunk length for (lanes, T) (``chunked.chunk_len``): 1024 at
    the CLI's 1024 lanes x 262144 (256 chunks)."""
    return chunked.chunk_len(lanes, T, CASCADE_ROWS)


def detector_chunk_len(lanes: int, T: int) -> int:
    """K7's and K8's chunk length for (lanes, T) (``chunked.chunk_len``):
    512 at K8's 512 lanes x 262144 (512 chunks), 1024 at K7's 1024 lanes
    (256 chunks)."""
    return chunked.chunk_len(lanes, T, DETECTOR_ROWS)


def _detector_table(lanes: int, T: int, dev):
    """(chunk length, an uninitialised carry table for it)."""
    L = detector_chunk_len(lanes, T)
    return L, torch.empty((-(-T // L), DETECTOR_ROWS, lanes),
                          dtype=torch.float32, device=dev)


def linrec_chunk_len(lanes: int, T: int) -> int:
    """K11's chunk length for (lanes, T) (``chunked.chunk_len``): 1024 at
    the fx chain's 1024 lanes x 262144 (256 chunks)."""
    return chunked.chunk_len(lanes, T, RECURRENCE_ROWS)


def _lead_vec(v, lead_shape, dev) -> torch.Tensor:
    """A per-lane parameter broadcast to the lead dims, flattened."""
    return torch.as_tensor(v, dtype=torch.float32, device=dev).expand(
        lead_shape).reshape(math.prod(lead_shape))


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
                         shared_channels: int,
                         dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of K6: the same operations in the same order,
    one time step at a time over all lanes (on the CPU in numpy,
    ``chunked.serial_steps``). Returns (lanes, T) in ``dtype``: float32 (the
    kernel's arithmetic) or float64 (a witness of its rounding)."""
    S = num_sections
    lanes = vec.shape[1]
    x_in, vec = x_in.to(dtype), vec.to(dtype)
    if shared_channels:
        x_in = x_in[torch.arange(lanes, device=x_in.device) % shared_channels]
    h = chunked.host(vec)
    co = [[h[5 * s + j] for j in range(5)] for s in range(S)]
    act = h[5 * S] if with_active else None
    zero = chunked.array_module(vec).zeros_like(h[0])
    st = [[zero, zero] for _ in range(S)]
    cols = []
    for xin in chunked.serial_steps(x_in):
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
    return chunked.serial_stack(cols, x_in)


def biquad_cascade_cuda(x_in, vec, num_sections: int, with_active: bool,
                        shared_channels: int) -> torch.Tensor:
    """Launch K6 on the current stream, in chunks of
    ``cascade_chunk_len(lanes, T)`` samples. Returns (lanes, T). Its three
    launches count as one."""
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
    L = cascade_chunk_len(lanes, T)
    table = torch.empty((-(-T // L), CASCADE_ROWS, lanes),
                        dtype=torch.float32, device=x_in.device)
    fn = lib.biquad_cascade_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x_in.data_ptr(), shared_channels, vec.data_ptr(), out.data_ptr(),
             table.data_ptr(), lanes, T, num_sections, int(with_active), L,
             -1, _stream(x_in))
    if err != 0:
        raise RuntimeError(f"biquad cascade kernel launch failed: CUDA error "
                           f"{err}")
    launches["biquad_cascade"] += 1
    return out


def biquad_cascade(x, b, a, active=None, shared_lead_shape=None):
    """The biquad cascade over the last axis, parallel over the leading
    dims (on the card a chunked scan, held to the serial chain by
    ``chunked.gate_excess``). x: (..., T), or the population-shared (C, T) input with
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


# ------------------------------------------------------------------ K7


def compressor_fused_inputs(x, threshold_db, ratio, knee_db, alpha_attack,
                            alpha_release, makeup_gain_db=0.0, active=None):
    """The kernel's inputs as ``scan.py:451-468`` prepares them.

    Returns (x_in (lanes, T), vec, with_active, lead_shape): vec is the
    (6 [+ 1], lanes) float32 table th, slope = 1/ratio - 1,
    knee = max(knee_db, 1e-3), aa, ar, mk = 10^(makeup/20) and, with a
    bypass mask, the mask."""
    lead_shape = tuple(x.shape[:-1])
    dev = x.device

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev)

    rows = [f32(threshold_db), 1.0 / f32(ratio) - 1.0,
            torch.clamp_min(f32(knee_db), 1e-3), f32(alpha_attack),
            f32(alpha_release), torch.pow(10.0, f32(makeup_gain_db) / 20.0)]
    if active is not None:
        rows.append(f32(active))
    vec = torch.stack([_lead_vec(r, lead_shape, dev) for r in rows])
    x_in = x.to(torch.float32).reshape(-1, x.shape[-1]).contiguous()
    return x_in, vec.contiguous(), active is not None, lead_shape


def compressor_fused_plain(x_in, vec, with_active: bool,
                           dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of K7 in the kernel's order: the gain computer
    over the whole block, the decoupled ballistics one time step at a time
    over all lanes (K8's plain version), then the gain and the bypass
    blend. Returns (lanes, T) in ``dtype``: float32 (the kernel's
    arithmetic) or float64 (a witness of its rounding)."""
    x_in, vec = x_in.to(dtype), vec.to(dtype)
    th, slope, knee, _, _, mk = (v[:, None] for v in vec[:6])
    env_db = torch.log(torch.clamp_min(x_in.abs(), 1e-8)) * _DB_PER_LOG
    over = env_db - th
    h = over + knee / 2.0
    knee_region = slope * (h * h) / (2.0 * knee)
    c = torch.where(2.0 * over < -knee, torch.zeros_like(over),
                    torch.where(2.0 * over > knee, slope * over, knee_region))
    g = ballistics_plain(c, vec[3:5], dtype)
    y = x_in * torch.exp(g * _LN10_OVER_20) * mk
    if with_active:
        act = vec[6][:, None]
        y = act * y + (1.0 - act) * x_in
    return y


def compressor_fused_cuda(x_in, vec, with_active: bool) -> torch.Tensor:
    """Launch K7 on the current stream, in chunks of
    ``detector_chunk_len(lanes, T)`` samples. Returns (lanes, T). Its five
    launches count as one."""
    lib = _build.load("scan")
    _check_cuda(x_in, vec)
    lanes, T = x_in.shape
    if vec.shape != (6 + int(with_active), lanes):
        raise ValueError(f"vec is {tuple(vec.shape)}, expected "
                         f"({6 + int(with_active)}, {lanes})")
    out = torch.empty((lanes, T), dtype=torch.float32, device=x_in.device)
    L, table = _detector_table(lanes, T, x_in.device)
    fn = lib.compressor_fused_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x_in.data_ptr(), vec.data_ptr(), out.data_ptr(),
             table.data_ptr(), lanes, T, int(with_active), L, -1,
             _stream(x_in))
    if err != 0:
        raise RuntimeError(f"compressor kernel launch failed: CUDA error "
                           f"{err}")
    launches["compressor_fused"] += 1
    return out


def compressor_fused(x, threshold_db, ratio, knee_db, alpha_attack,
                     alpha_release, makeup_gain_db=0.0, active=None):
    """The whole unlinked feed-forward compressor as one pass. x: (..., T);
    the parameters broadcast to x's leading dims; ``active``: optional
    float bypass mask (1.0 = effect on), blended in-kernel. Returns x's
    shape, float32."""
    x_in, vec, with_active, lead_shape = compressor_fused_inputs(
        x, threshold_db, ratio, knee_db, alpha_attack, alpha_release,
        makeup_gain_db, active)
    if x.device.type == "cpu":
        out = compressor_fused_plain(x_in, vec, with_active)
    else:
        out = compressor_fused_cuda(x_in, vec, with_active)
    return out.reshape(*lead_shape, x.shape[-1])


# ------------------------------------------------------------------ K8


def ballistics_inputs(c, alpha_attack, alpha_release):
    """(c_in (lanes, T), vec (2, lanes) = [aa; ar], lead_shape)."""
    lead_shape = tuple(c.shape[:-1])
    c_in = c.to(torch.float32).reshape(-1, c.shape[-1]).contiguous()
    vec = torch.stack([_lead_vec(alpha_attack, lead_shape, c.device),
                       _lead_vec(alpha_release, lead_shape, c.device)])
    return c_in, vec.contiguous(), lead_shape


def ballistics_plain(c_in, vec, dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of K8: the decoupled detector one time step at
    a time over all lanes (on the CPU in numpy, ``chunked.serial_steps``).
    Returns (lanes, T) in ``dtype``: float32 (the kernel's arithmetic) or
    float64 (a witness of its rounding)."""
    c_in, vec = c_in.to(dtype), vec.to(dtype)
    xp, h = chunked.array_module(vec), chunked.host(vec)
    aa, ar = h[0], h[1]
    y1 = g = xp.zeros_like(aa)
    out = []
    for ct in chunked.serial_steps(c_in):
        y1 = xp.minimum(ct, ar * y1 + (1.0 - ar) * ct)
        g = aa * g + (1.0 - aa) * y1
        out.append(g)
    return chunked.serial_stack(out, c_in)


def ballistics_cuda(c_in, vec) -> torch.Tensor:
    """Launch K8 on the current stream, in chunks of
    ``detector_chunk_len(lanes, T)`` samples. Returns (lanes, T). Its five
    launches count as one."""
    lib = _build.load("scan")
    _check_cuda(c_in, vec)
    lanes, T = c_in.shape
    if vec.shape != (2, lanes):
        raise ValueError(f"vec is {tuple(vec.shape)}, expected (2, {lanes})")
    out = torch.empty((lanes, T), dtype=torch.float32, device=c_in.device)
    L, table = _detector_table(lanes, T, c_in.device)
    fn = lib.ballistics_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(c_in.data_ptr(), vec.data_ptr(), out.data_ptr(),
             table.data_ptr(), lanes, T, L, -1, _stream(c_in))
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


# ----------------------------------------------------------------- K11


def linear_recurrence_plain(a_in, b_in, dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of K11: y = a*y + b from y = 0, one time step
    at a time over all lanes (on the CPU in numpy,
    ``chunked.serial_steps``). a_in, b_in (lanes, T); returns (lanes, T) in
    ``dtype``: float32 (the kernel's arithmetic) or float64 (a witness of
    its rounding)."""
    a_in, b_in = a_in.to(dtype), b_in.to(dtype)
    y = chunked.array_module(a_in).zeros_like(chunked.host(a_in[:, 0]))
    out = []
    for at, bt in zip(chunked.serial_steps(a_in), chunked.serial_steps(b_in)):
        y = at * y + bt
        out.append(y)
    return chunked.serial_stack(out, a_in)


def linrec_table(lanes: int, T: int, dev):
    """(K11's chunk length, an uninitialised carry table for it)."""
    L = linrec_chunk_len(lanes, T)
    return L, torch.empty((-(-T // L), RECURRENCE_ROWS, lanes),
                          dtype=torch.float32, device=dev)


def linear_recurrence_launch(a_in, b_in, out, table, L: int,
                             stage: int = -1) -> None:
    """One launch of K11's C entry point on the current stream, in chunks
    of L samples with the carry table ``table``: the whole scan (stage -1)
    or one stage of it (0 pass A, 1 the carry, 2 pass D), so that a tool
    can time the stages apart. Raises when the launch fails."""
    lib = _build.load("scan")
    lanes, T = a_in.shape
    fn = lib.linear_recurrence_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(a_in.data_ptr(), b_in.data_ptr(), out.data_ptr(),
             table.data_ptr(), lanes, T, L, stage, _stream(a_in))
    if err != 0:
        raise RuntimeError(f"linear recurrence kernel launch failed: CUDA "
                           f"error {err}")


def linear_recurrence_cuda(a_in, b_in) -> torch.Tensor:
    """Launch K11 on the current stream, in chunks of
    ``linrec_chunk_len(lanes, T)`` samples. Returns (lanes, T). Its three
    launches count as one."""
    _build.load("scan")  # raises first when the library cannot be had
    _check_cuda(a_in, b_in)
    if a_in.ndim != 2 or a_in.shape != b_in.shape:
        raise ValueError(f"a and b must be one (lanes, T) shape, got "
                         f"{tuple(a_in.shape)} and {tuple(b_in.shape)}")
    lanes, T = a_in.shape
    out = torch.empty((lanes, T), dtype=torch.float32, device=a_in.device)
    L, table = linrec_table(lanes, T, a_in.device)
    linear_recurrence_launch(a_in, b_in, out, table, L)
    launches["linear_recurrence"] += 1
    return out


def linear_recurrence(coeff, drive):
    """y[t] = coeff[t]*y[t-1] + drive[t] along the last axis, y[-1] = 0;
    coeff and drive of one shape (..., T). Returns that shape, float32."""
    if coeff.shape != drive.shape:
        raise ValueError(f"coeff {tuple(coeff.shape)} and drive "
                         f"{tuple(drive.shape)} differ")
    T = coeff.shape[-1]
    a_in, b_in = (v.to(torch.float32).reshape(-1, T).contiguous()
                  for v in (coeff, drive))
    if coeff.device.type == "cpu":
        out = linear_recurrence_plain(a_in, b_in)
    else:
        out = linear_recurrence_cuda(a_in, b_in)
    return out.reshape(coeff.shape)
