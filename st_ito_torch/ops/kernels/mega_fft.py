"""K5, K3, K4: the packed stereo FFT pair of the fused LTI group, and the
``mega`` and ``mega2`` group applications built on them.

Port of ``st_ito_tpu/ops/pallas/mega_fft.py`` under the same public names:

- ``fwd_pack_fft`` (K5, ``:395``): z = L + iR, Z = FFT_n(z), emitted as the
  two half grids Zlo[k] = Z[k] and Zrev[k] = Z[(n-k) mod n];
- ``fwd_pack_fft_response`` (K3, ``:431``): K5 with K2's response math as
  its epilogue, emitting (Ylo, Yhig); the Z spectra never reach device
  memory;
- ``inv_unpack_fft`` (K4, ``:489``): Y rebuilt from (Ylo, Yhig), inverse
  FFT, L = re/n, R = im/n, the first T samples;
- ``packed_lti_apply_mega`` (K5 -> K2 -> K4) and ``packed_lti_apply_mega2``
  (K3 -> K4), drop-in alternatives to ``ops/lti.py packed_lti_apply_rp``.

Layout: a half grid is (B, Rp, n1) float32, which is a row of pitch
Fp = Rp*n1 per candidate with bin k at flat index k. The bins k <= n/2 are
valid; whatever lies past them is junk (the kernels leave it as allocated,
the plain versions write zeros) and K4 never reads it into a sum. Pitched
rows are 16-byte aligned, which rows of the odd F = n/2 + 1 are not.

The CUDA kernels are ``st_ito_torch/csrc/mega_fft.cu`` (float32 butterfly
FFTs, ``csrc/fft_core.cuh``; K5, K3 and K4 one persistent launch each on
the scheduler of ``csrc/fft_persist.cuh``; K3 forms the Freeverb table's
phasors from row and column factors, ``freeverb_factors``, and reads only
the table's allpass rows). Beside each wrapper stands its plain PyTorch
version (``torch.fft`` with the flip and reassembly glue of ``ops/lti.py``),
which the CPU tests use and the card never runs on the main path: a
wrapper takes the plain version only for a CPU tensor, and on any other
launches the kernel or raises. The TPU kernel's ``precision`` (bf16 dot
passes) and ``rows`` (hop-blocked output) arguments are TPU devices and are
not carried.
"""

from __future__ import annotations

import ctypes
import math

import torch

from st_ito_torch.ops.kernels import _build
from st_ito_torch.ops.kernels import packed_response as _pr

# Kernel launches since the last reset, by wrapper (chip_smoke.py and
# portbench/core/counters.py read them)
launches = {"fwd_pack_fft": 0, "fwd_pack_fft_response": 0,
            "inv_unpack_fft": 0}

# the kernels form the twiddle index k1*j2 < n exactly in float32
_MAX_N = 1 << 24


def _radix(n: int) -> tuple[int, int]:
    k = n.bit_length() - 1
    if (1 << k) != n:
        raise ValueError(f"mega_fft requires a power-of-two size, got {n}")
    n1 = 1 << ((k + 1) // 2)
    return n1, n // n1


def _pad8(x: int) -> int:
    return -(-x // 8) * 8


def half_grid(n: int) -> tuple[int, int]:
    """(Rp, n1): the padded half-grid row count and row width. Flat arrays
    are (B, Rp * n1) with bin k at flat index k (k <= n/2)."""
    n1, n2 = _radix(n)
    return _pad8(n2 // 2 + 1), n1


def supported(n: int, T: int) -> bool:
    """The shapes the mega path takes (the JAX package's rule, kept so that
    both packages route a shape the same way); any other takes the ``mx``
    path in the renderer."""
    if n <= 0 or (n & (n - 1)):
        return False
    n1, n2 = _radix(n)
    return n2 >= 128 and n1 >= 128 and T % n2 == 0 and 0 < T <= n


def _check_nT(n: int, T: int) -> None:
    if not supported(n, T):
        raise ValueError(f"mega_fft: unsupported (n={n}, T={T})")


# ------------------------------------------------------------ plain versions


def _to_half_grid(v: torch.Tensor, n: int) -> torch.Tensor:
    """(B, F) valid bins -> (B, Rp, n1), zeros past F."""
    Rp, n1 = half_grid(n)
    out = torch.zeros((v.shape[0], Rp * n1), dtype=v.dtype, device=v.device)
    out[:, :v.shape[1]] = v
    return out.reshape(-1, Rp, n1)


def fwd_pack_fft_plain(x: torch.Tensor, n: int):
    """Plain version of K5: ``torch.fft.fft`` of complex(L, R) at size n and
    the flip that builds Zrev, written into the pitched layout."""
    _check_nT(n, x.shape[-1])
    F = n // 2 + 1
    Z = torch.fft.fft(torch.complex(x[:, 0], x[:, 1]), n=n, dim=-1)
    Zrev = torch.cat([Z[:, :1], torch.flip(Z[:, n // 2:], (-1,))], -1)
    Zlo = Z[:, :F]
    return tuple(_to_half_grid(v, n)
                 for v in (Zlo.real, Zlo.imag, Zrev.real, Zrev.imag))


def fwd_pack_fft_response_plain(x: torch.Tensor, stages, n: int, tables):
    """Plain version of K3: K5's plain version, then K2's."""
    return _pr.packed_response_padded_plain(*fwd_pack_fft_plain(x, n),
                                            stages, tables, n)


def inv_unpack_fft_plain(YloR, YloI, YhigR, YhigI, n: int, T: int):
    """Plain version of K4: Y = [Ylo[0..n/2], flip(Yhig[1..n/2-1])] from the
    valid bins only, ``torch.fft.ifft`` (which scales by 1/n), the first T
    samples as (L, R) = (re, im)."""
    _check_nT(n, T)
    B = YloR.shape[0]
    F = n // 2 + 1
    lo_r, lo_i, hi_r, hi_i = (v.reshape(B, -1) for v in
                              (YloR, YloI, YhigR, YhigI))
    Y = torch.complex(
        torch.cat([lo_r[:, :F], torch.flip(hi_r[:, 1:n // 2], (-1,))], -1),
        torch.cat([lo_i[:, :F], torch.flip(hi_i[:, 1:n // 2], (-1,))], -1))
    y = torch.fft.ifft(Y, n=n, dim=-1)[:, :T]
    return torch.stack([y.real, y.imag], dim=1)


# ---------------------------------------------------------------- kernels

_TWIDDLES: dict = {}
_SCRATCH: dict = {}


def _twiddles(n1: int, dev) -> torch.Tensor:
    """W_n1^j = exp(-2 pi i j / n1), j < n1/2, as (n1/2, 2) float32, computed
    in float64; built once per (n1, device)."""
    key = (n1, dev)
    if key not in _TWIDDLES:
        ang = (-2.0 * math.pi / n1) * torch.arange(n1 // 2,
                                                   dtype=torch.float64)
        _TWIDDLES[key] = torch.stack([torch.cos(ang), torch.sin(ang)], -1).to(
            device=dev, dtype=torch.float32).contiguous()
    return _TWIDDLES[key]


_ROOTS: dict = {}


def _roots(n: int, dev) -> torch.Tensor:
    """The n-th roots the persistent kernels' twiddle W_n^(k1*j2) is made
    of, as (n2 + n1, 2) float32 computed in float64: W_n^(h*n1) for h < n2,
    then W_n^l for l < n1 (k1*j2 = h*n1 + l); built once per (n, device)."""
    key = (n, dev)
    if key not in _ROOTS:
        n1, n2 = _radix(n)
        e = torch.cat([torch.arange(n2, dtype=torch.float64) * n1,
                       torch.arange(n1, dtype=torch.float64)])
        ang = (-2.0 * math.pi / n) * e
        _ROOTS[key] = torch.stack([torch.cos(ang), torch.sin(ang)], -1).to(
            device=dev, dtype=torch.float32).contiguous()
    return _ROOTS[key]


# the Freeverb table's allpass rows (chain/rp_responses.py FREEVERB_ROWS)
ALLPASS_ROWS = slice(34, 38)
# a factor row's phasors and its pad (csrc/mega_fft.cu kFactorPitch)
FACTOR_PITCH = 18
_FACTORS: dict = {}


def freeverb_factors(delays, n: int, dev):
    """(u, v): the factors of the Freeverb table's phasors over the
    four-step grid. The phasor of delay D at bin k = k2*n1 + k1 is
    e^(i 2 pi k D / n) = e^(i 2 pi (k2 D mod n2) / n2) e^(i 2 pi (k1 D mod
    n) / n): u (n2, FACTOR_PITCH, 2) and v (n1, FACTOR_PITCH, 2) float32
    (cos, sin), row k holding the factor of each delay (the table's 17
    phasors: z^-1, then the combs of L and of R) and a zero pad, formed in
    float64 from the exact integer phases. Built once per (delays, n,
    device)."""
    key = (tuple(delays), n, dev)
    if key not in _FACTORS:
        n1, n2 = _radix(n)
        D = torch.tensor(delays, dtype=torch.int64)[None, :]

        def phasors(k, m):
            ang = (2.0 * math.pi / m) * ((k[:, None] * D) % m).double()
            out = torch.zeros((len(k), FACTOR_PITCH, 2), dtype=torch.float64)
            out[:, :D.shape[1]] = torch.stack([torch.cos(ang),
                                               torch.sin(ang)], -1)
            return out.to(device=dev, dtype=torch.float32).contiguous()

        _FACTORS[key] = (phasors(torch.arange(n2), n2),
                         phasors(torch.arange(n1), n))
    return _FACTORS[key]


def _scratch(n: int, slots: int, dev) -> torch.Tensor:
    """The persistent kernels' ring of `slots` one-candidate scratch slots,
    (slots, n, 2) float32, allocated once per (n, slots, device) and shared
    by K5, K3 and K4 (and K10's of the same shape): each call's passes run
    in order on one stream."""
    key = (n, slots, dev)
    if key not in _SCRATCH:
        _SCRATCH[key] = torch.empty((slots, n, 2), dtype=torch.float32,
                                    device=dev)
    return _SCRATCH[key]


def _device(t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"the mega_fft kernels need CUDA tensors, got "
                         f"{t.device}")
    return t.device


def _check_x(x: torch.Tensor, n: int) -> None:
    if (x.ndim != 3 or x.shape[1] != 2 or x.dtype != torch.float32
            or not x.is_contiguous()):
        raise ValueError("the forward kernels take a contiguous float32 "
                         f"(B, 2, T) tensor, got {tuple(x.shape)} {x.dtype}")
    _check_nT(n, x.shape[-1])


def scratch_slots() -> int:
    """The candidates the persistent kernels' scratch ring holds (builds
    the kernels)."""
    fn = _build.load("mega_fft").mega_fft_scratch_slots
    fn.restype = ctypes.c_int
    return fn()


def _forward_args(x: torch.Tensor, n: int):
    """(dev, the four outputs, the counters, the persistent forward's
    common arguments) of one launch. The caller holds the counters until it
    has launched: freed earlier, their memory could go to a tensor made in
    between (the stage parameters), which the kernel's zeroing of its
    counters would then overwrite."""
    dev = _device(x)
    _check_x(x, n)
    if n > _MAX_N:
        raise ValueError(f"the mega_fft kernels take n <= {_MAX_N}, got {n}")
    B, _, T = x.shape
    n1, n2 = _radix(n)
    Rp, _ = half_grid(n)
    outs = [torch.empty((B, Rp, n1), dtype=torch.float32, device=dev)
            for _ in range(4)]
    counters = torch.empty(1 + 2 * B, dtype=torch.int32, device=dev)
    ptrs = (x.data_ptr(), *(o.data_ptr() for o in outs),
            _scratch(n, scratch_slots(), dev).data_ptr(),
            _twiddles(n1, dev).data_ptr(), _roots(n, dev).data_ptr(),
            counters.data_ptr(), B, T, n1, n2, Rp * n1)
    return dev, outs, counters, ptrs


_FWD_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_longlong]


def fwd_pack_fft_cuda(x: torch.Tensor, n: int):
    """Launch K5 on the current stream."""
    lib = _build.load("mega_fft")
    dev, outs, counters, ptrs = _forward_args(x, n)
    fn = lib.fwd_pack_fft_launch
    fn.argtypes = _FWD_ARGS + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*ptrs, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fwd_pack_fft_launch failed: CUDA error {err}")
    launches["fwd_pack_fft"] += 1
    return tuple(outs)


def fwd_pack_fft_response_cuda(x: torch.Tensor, stages, n: int, tables,
                               stage: int = -1):
    """Launch K3 on the current stream. ``stage`` >= 0 launches one of the
    kernel's timing probes instead (``tools/k3_stages.py``): 0 pass 1
    alone, 1 to 3 pass 1 and pass 2 emitting Z, Z plus the Freeverb
    values' loads and products, and the whole epilogue."""
    lib = _build.load("mega_fft")
    dev, outs, counters, ptrs = _forward_args(x, n)
    B, F = x.shape[0], n // 2 + 1
    codes, n_stages, prm, act, table, sr = _pr.stage_args(stages, B, F,
                                                          tables, dev)
    ap = u = v = None
    if table is not None:
        ap = table[ALLPASS_ROWS]  # rows of the contiguous (38, F) table
        u, v = freeverb_factors(tables["reverb"]["_phasor_delays"], n, dev)
    fn = lib.fwd_pack_fft_response_launch
    fn.argtypes = _FWD_ARGS + [
        ctypes.c_uint, ctypes.c_int] + [ctypes.c_void_p] * 5 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*ptrs, codes, n_stages, prm.data_ptr(), _pr.data_ptr(act),
             *(_pr.data_ptr(t) for t in (ap, u, v)), 2.0 * math.pi / n, sr,
             stage, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("fwd_pack_fft_response_launch failed: CUDA error "
                           f"{err}")
    launches["fwd_pack_fft_response"] += 1
    return tuple(outs)


_INV_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])


def inv_unpack_fft_cuda(YloR, YloI, YhigR, YhigI, n: int, T: int,
                        stage: int = -1):
    """Launch K4 on the current stream: one persistent launch through the
    scratch ring. ``stage`` 0 launches its timing probe instead
    (``tools/k4_stages.py``): pass 1 of every candidate alone."""
    lib = _build.load("mega_fft")
    dev = _device(YloR)
    _check_nT(n, T)
    if n > _MAX_N:
        raise ValueError(f"the mega_fft kernels take n <= {_MAX_N}, got {n}")
    B = YloR.shape[0]
    shape = (B,) + half_grid(n)
    for v in (YloR, YloI, YhigR, YhigI):
        if (v.device != dev or v.dtype != torch.float32
                or not v.is_contiguous() or tuple(v.shape) != shape):
            raise ValueError("inv_unpack_fft takes four contiguous float32 "
                             f"{shape} tensors on one CUDA device")
    n1, n2 = _radix(n)
    y = torch.empty((B, 2, T), dtype=torch.float32, device=dev)
    # held until the launch is made (_forward_args says why)
    counters = torch.empty(1 + 2 * B, dtype=torch.int32, device=dev)
    fn = lib.inv_unpack_fft_launch
    fn.argtypes = _INV_ARGS
    fn.restype = ctypes.c_int
    err = fn(YloR.data_ptr(), YloI.data_ptr(), YhigR.data_ptr(),
             YhigI.data_ptr(), y.data_ptr(),
             _scratch(n, scratch_slots(), dev).data_ptr(),
             _twiddles(n1, dev).data_ptr(), _roots(n, dev).data_ptr(),
             counters.data_ptr(), B, T, n1, n2, shape[1] * n1, stage,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"inv_unpack_fft_launch failed: CUDA error {err}")
    launches["inv_unpack_fft"] += 1
    return y


# --------------------------------------------------------------- wrappers


def fwd_pack_fft(x: torch.Tensor, n: int):
    """x (B, 2, T) float32 -> (ZloR, ZloI, ZrevR, ZrevI), each (B, Rp, n1)
    float32 with bin k of Z = FFT(L + iR, n) at (k // n1, k % n1) for
    k <= n/2, and of Zrev[k] = Z[(n-k) mod n] likewise."""
    if x.device.type == "cpu":
        return fwd_pack_fft_plain(x, n)
    return fwd_pack_fft_cuda(x, n)


def _tables(stages, n: int, sample_rate: float, dev):
    return _pr.rp_tables([e for e, _, _ in stages], sample_rate, n, dev)


def fwd_pack_fft_response(x: torch.Tensor, stages, n: int,
                          sample_rate: float):
    """fwd_pack_fft with the LTI response fused into the kernel's epilogue:
    x (B, 2, T) float32 + rp stages -> (YloR, YloI, YhigR, YhigI), each
    (B, Rp, n1), DC/Nyquist-corrected, ready for inv_unpack_fft. The
    Freeverb table is the cached (38, F) one of ``rp_tables``, indexed by
    bin, so the pitched layout needs no second copy of it."""
    tables = _tables(stages, n, sample_rate, x.device)
    if x.device.type == "cpu":
        return fwd_pack_fft_response_plain(x, stages, n, tables)
    return fwd_pack_fft_response_cuda(x, stages, n, tables)


def inv_unpack_fft(YloR, YloI, YhigR, YhigI, n: int, T: int):
    """(Ylo, Yhig) half-grid arrays (B, Rp, n1) -> y (B, 2, T) float32, the
    scaled inverse FFT's (L, R) = (re, im) unpacking. Junk (bins > n/2 in
    Ylo, the k = 0 and Nyquist duplicates in Yhig, pad rows) is never
    read."""
    if YloR.device.type == "cpu":
        return inv_unpack_fft_plain(YloR, YloI, YhigR, YhigI, n, T)
    return inv_unpack_fft_cuda(YloR, YloI, YhigR, YhigI, n, T)


def packed_lti_apply_mega(x: torch.Tensor, stages, n: int,
                          sample_rate: float) -> torch.Tensor:
    """The fused-LTI group as K5 -> K2 -> K4. x (B, 2, T) float32; the
    caller guarantees ``supported(n, T)``."""
    tables = _tables(stages, n, sample_rate, x.device)
    Z = fwd_pack_fft(x, n)
    Y = _pr.packed_response_apply_rp_padded(*Z, stages, tables, n)
    del Z
    return inv_unpack_fft(*Y, n, x.shape[-1])


def packed_lti_apply_mega2(x: torch.Tensor, stages, n: int,
                           sample_rate: float) -> torch.Tensor:
    """The fused-LTI group as K3 -> K4: packed_lti_apply_mega without the
    eight (B, Fp) float32 round trips of the middle kernel."""
    Y = fwd_pack_fft_response(x, stages, n, sample_rate)
    return inv_unpack_fft(*Y, n, x.shape[-1])
