"""K1: the fused EQ -> compressor (-> distortion) scan.

Port of ``st_ito_tpu/ops/pallas/scan.py:279 eq_compressor_fused_pallas``.
The CUDA kernel is ``st_ito_torch/csrc/eqcomp.cu``, a chunked scan over T
(``chunk_len`` picks the chunk); beside it here is its plain PyTorch
version, a Python loop over T on (lanes,) tensors. The wrapper
``eq_compressor_fused`` runs the plain version for a CPU tensor and the
kernel for any other: on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from st_ito_torch.ops.kernels import _build, chunked

# Kernel launches since the last reset (chip_smoke.py reads it).
launches = 0

_DB_PER_LOG = 20.0 / math.log(10.0)
_LN10_OVER_20 = math.log(10.0) / 20.0
# vec rows after the 5 per section: eq_act, th, slope, knee, aa, ar, mk,
# comp_act, drive, outg, dist_act
_N_TAIL = 11
# the section count the kernel is instantiated for (the basic parametric EQ)
KERNEL_SECTIONS = 6


def table_rows(num_sections: int) -> int:
    """The carry table's floats per chunk and lane: the cascade state, the
    MinAffine (k, b, m) whose first row becomes y1, then g."""
    return 2 * num_sections + 4


def chunk_len(lanes: int, T: int, num_sections: int = KERNEL_SECTIONS) -> int:
    """The kernel's chunk length for (lanes, T) (``chunked.chunk_len``): a
    multiple of the 32-sample tile; 1024 at the headline's 1024 lanes x
    262144 (256 chunks)."""
    return chunked.chunk_len(lanes, T, table_rows(num_sections))


def eqcomp_inputs(x, b, a, threshold_db, ratio, knee_db, alpha_attack,
                  alpha_release, makeup_gain_db=0.0, eq_active=None,
                  comp_active=None, drive_db=None, dist_gain_db=0.0,
                  dist_active=None, shared_lead_shape=None):
    """The kernel's inputs as ``scan.py:313-352`` prepares them.

    Returns (x_in, vec, num_sections, with_dist, shared_channels,
    lead_shape): x_in is (lanes, T), or the shared (C, T) input when
    shared_channels = C > 0 (lane b*C + c reads x[c]); vec is the
    (5*S + 11, lanes) float32 table of per-lane scalars. Absent bypass masks
    are 1.0 (blending with 1.0 is the identity)."""
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
    dev = x.device

    b = b.to(torch.float32).expand(lead_shape + b.shape[-2:]).reshape(lead, S, 3)
    a = a.to(torch.float32).expand(lead_shape + a.shape[-2:]).reshape(lead, S, 3)

    def vec(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev).expand(
            lead_shape).reshape(lead)

    def pow10_20(v):
        return torch.pow(10.0, torch.as_tensor(v, dtype=torch.float32,
                                               device=dev) / 20.0)

    rows = []
    for s in range(S):
        rows += [b[:, s, 0], b[:, s, 1], b[:, s, 2], a[:, s, 1], a[:, s, 2]]
    ratio = torch.as_tensor(ratio, dtype=torch.float32, device=dev)
    knee = torch.clamp_min(torch.as_tensor(knee_db, dtype=torch.float32,
                                           device=dev), 1e-3)
    with_dist = drive_db is not None
    ones = torch.ones(lead, dtype=torch.float32, device=dev)
    rows += [
        ones if eq_active is None else vec(eq_active),
        vec(threshold_db),
        vec(1.0 / ratio - 1.0),
        vec(knee),
        vec(alpha_attack),
        vec(alpha_release),
        vec(pow10_20(makeup_gain_db)),
        ones if comp_active is None else vec(comp_active),
        vec(pow10_20(drive_db)) if with_dist else ones,
        vec(pow10_20(dist_gain_db)) if with_dist else ones,
        ones if (dist_active is None or not with_dist) else vec(dist_active),
    ]
    table = torch.stack(rows).contiguous()
    if shared_lead_shape is not None:
        x_in, shared_channels = x.to(torch.float32).contiguous(), x.shape[0]
    else:
        x_in = x.to(torch.float32).reshape(lead, T).contiguous()
        shared_channels = 0
    return x_in, table, S, with_dist, shared_channels, lead_shape


def eqcomp_plain(x_in, vec, num_sections: int, with_dist: bool,
                 shared_channels: int, dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of the kernel: its step, one time step at a
    time over all lanes (the two serial loops on the CPU in numpy,
    ``chunked.serial_steps``). Returns (lanes, T) in ``dtype``: float32
    (the kernel's arithmetic) or float64 (a witness of its rounding)."""
    S = num_sections
    lanes = vec.shape[1]
    x_in, vec = x_in.to(dtype), vec.to(dtype)
    if shared_channels:
        chan = torch.arange(lanes, device=x_in.device) % shared_channels
        x_in = x_in[chan]
    xp, hv = chunked.array_module(vec), chunked.host(vec)
    co = [[hv[5 * s + j] for j in range(5)] for s in range(S)]
    (_, th, slope, knee, _, _, mk, comp_act, drive, outg,
     dist_act) = vec[5 * S:5 * S + _N_TAIL]
    eq_act, aa, ar = (hv[5 * S + i] for i in (0, 4, 5))

    # EQ: serial biquad cascade, then the bypass blend
    zero = xp.zeros_like(hv[0])
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
        cols.append(eq_act * v + (1.0 - eq_act) * xin)
    v = chunked.serial_stack(cols, x_in)

    # gain computer on the EQ output (vectorised over time)
    env_db = torch.log(torch.clamp_min(v.abs(), 1e-8)) * _DB_PER_LOG
    over = env_db - th[:, None]
    h = over + knee[:, None] / 2.0
    knee_region = slope[:, None] * (h * h) / (2.0 * knee[:, None])
    c = torch.where(2.0 * over < -knee[:, None], torch.zeros_like(over),
                    torch.where(2.0 * over > knee[:, None],
                                slope[:, None] * over, knee_region))

    # decoupled ballistics, serial
    y1 = g = zero
    gs = []
    for ct in chunked.serial_steps(c):
        y1 = xp.minimum(ct, ar * y1 + (1.0 - ar) * ct)
        g = aa * g + (1.0 - aa) * y1
        gs.append(g)
    g = chunked.serial_stack(gs, c)

    y = v * torch.exp(g * _LN10_OVER_20) * mk[:, None]
    y = comp_act[:, None] * y + (1.0 - comp_act[:, None]) * v
    if with_dist:
        yd = torch.tanh(y * drive[:, None]) * outg[:, None]
        y = dist_act[:, None] * yd + (1.0 - dist_act[:, None]) * y
    return y


def gate_excess(got, want32, vec, num_sections: int, with_dist: bool,
                want64=None) -> dict:
    """How far the kernel's output ``got`` (lanes, T) lies past its two
    accuracy rules (``chunked.gate_excess``); each value is <= 0 when the
    rule holds on every lane.

    The kernel's chunk carries round differently from the serial chain of
    the plain version, and tanh multiplies a rounding of y by up to
    drive x output gain, so rule (a), max_t |got - want32| <= 1e-4 x
    max(1, max_t |want32|), is held only where a lane's distortion is
    bypassed (or absent); rule (b), against the float64 plain run
    ``want64``, on every lane. "a" is -inf where no lane is bypassed."""
    bypassed = (vec[5 * num_sections + 10] == 0) if with_dist else None
    return chunked.gate_excess(got, want32, want64=want64,
                               rule_a_lanes=bypassed)


def eqcomp_cuda(x_in, vec, num_sections: int, with_dist: bool,
                shared_channels: int) -> torch.Tensor:
    """Launch the kernel on the current stream, in chunks of
    ``chunk_len(lanes, T)`` samples. Returns (lanes, T). Its seven launches
    count as one."""
    global launches
    lib = _build.load("eqcomp")
    for t in (x_in, vec):
        if t.device.type != "cuda" or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError("eqcomp kernel takes contiguous float32 CUDA "
                             f"tensors, got {t.device} {t.dtype}")
    if x_in.device != vec.device:
        raise ValueError("eqcomp inputs lie on different devices")
    lanes = vec.shape[1]
    T = x_in.shape[-1]
    if num_sections != KERNEL_SECTIONS:
        raise ValueError(f"the eqcomp kernel is built for {KERNEL_SECTIONS} "
                         f"biquad sections, got {num_sections}")
    if vec.shape[0] != 5 * num_sections + _N_TAIL:
        raise ValueError(f"vec has {vec.shape[0]} rows, expected "
                         f"{5 * num_sections + _N_TAIL}")
    if shared_channels == 0 and x_in.shape[0] != lanes:
        raise ValueError(f"x has {x_in.shape[0]} lanes, vec {lanes}")
    L = chunk_len(lanes, T, num_sections)
    out = torch.empty((lanes, T), dtype=torch.float32, device=x_in.device)
    table = torch.empty((-(-T // L), table_rows(num_sections), lanes),
                        dtype=torch.float32, device=x_in.device)
    fn = lib.eqcomp_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x_in.data_ptr(), shared_channels, vec.data_ptr(), out.data_ptr(),
             table.data_ptr(), lanes, T, num_sections, int(with_dist), L,
             torch.cuda.current_stream(x_in.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"eqcomp kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def eq_compressor_fused(x, b, a, threshold_db, ratio, knee_db, alpha_attack,
                        alpha_release, makeup_gain_db=0.0, eq_active=None,
                        comp_active=None, drive_db=None, dist_gain_db=0.0,
                        dist_active=None, shared_lead_shape=None):
    """Biquad-cascade EQ followed by the unlinked feed-forward compressor
    (and, when ``drive_db`` is given, the tanh distortion with its output
    gain) as one pass. x: (..., T), or the population-shared (C, T) input
    with ``shared_lead_shape=(B, C)``; b, a: (..., S, 3) with a0 = 1;
    the other parameters broadcast to x's leading dims. ``*_active``:
    optional float bypass masks (1.0 = effect on). Returns
    (*lead_shape, T) float32."""
    x_in, vec, S, with_dist, shared, lead_shape = eqcomp_inputs(
        x, b, a, threshold_db, ratio, knee_db, alpha_attack, alpha_release,
        makeup_gain_db, eq_active, comp_active, drive_db, dist_gain_db,
        dist_active, shared_lead_shape)
    if x.device.type == "cpu":
        out = eqcomp_plain(x_in, vec, S, with_dist, shared)
    else:
        out = eqcomp_cuda(x_in, vec, S, with_dist, shared)
    return out.reshape(*lead_shape, x.shape[-1])
