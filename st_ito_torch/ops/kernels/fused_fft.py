"""K10: a batched complex DFT of size n on planar float32 rows.

Port of ``st_ito_tpu/ops/pallas/fused_fft.py:167 fft_fused`` under the same
names and contract: ``zr``/``zi`` (B, in_len) with in_len <= n an implicit
zero pad and a multiple of n2; ``sign=-1`` forward, ``+1`` inverse
(unscaled); ``out_len`` keeps the first outputs. The TPU kernel's
``precision`` reached float32 through bf16 dot passes (``_bf16_split``,
``_dot3``); here every transform is float32, so "high" and "highest" are
taken and mean the same, and the reduced modes are not ported.

The CUDA kernel is ``st_ito_torch/csrc/fused_fft.cu`` (a four-step FFT in
two passes on the butterflies of ``csrc/fft_core.cuh``, one persistent
launch through a scratch ring of ``scratch_slots()`` candidates that stays
in L2). Beside it stands
its plain PyTorch version ``fft_fused_plain`` (``torch.fft``), which the CPU
tests use: the wrapper takes it only for a CPU tensor, and on any other
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from st_ito_torch.ops.kernels import _build
# the same n = n1*n2 split, size limit, twiddle and root tables and scratch
# cache as K5, K3 and K4
from st_ito_torch.ops.kernels.mega_fft import _MAX_N, _radix, _roots, \
    _scratch, _twiddles

# Kernel launches since the last reset (chip_smoke.py and
# portbench/core/counters.py read it).
launches = 0


def scratch_slots() -> int:
    """The candidates the kernel's scratch ring holds (builds the kernel)."""
    fn = _build.load("fused_fft").fft_fused_scratch_slots
    fn.restype = ctypes.c_int
    return fn()


def supported(n: int, in_len: int) -> bool:
    """The shapes ``fft_fused`` takes (the JAX package's rule, kept so that
    both packages route a shape the same way): a power-of-two n whose
    split has n1, n2 >= 128, and in_len <= n a multiple of n2."""
    if n <= 0 or (n & (n - 1)):
        return False
    n1, n2 = _radix(n)
    return n2 >= 128 and n1 >= 128 and in_len % n2 == 0 and in_len <= n


def _shape(zr: torch.Tensor, zi: torch.Tensor, n, out_len, precision):
    """(n, out_len) of one call, after the JAX package's checks."""
    if precision not in ("high", "highest"):
        raise NotImplementedError(
            f"fft_fused precision={precision!r}: every transform is float32 "
            f"('high' or 'highest'); the bf16 dot modes are TPU devices "
            f"(ROADMAP §2)")
    if zr.ndim != 2 or zr.shape != zi.shape:
        raise ValueError(f"fft_fused takes two (B, in_len) arrays, got "
                         f"{tuple(zr.shape)} and {tuple(zi.shape)}")
    in_len = zr.shape[1]
    n = n or in_len
    if not supported(n, in_len):
        n2 = _radix(n)[1] if n > 0 and not n & (n - 1) else None
        raise ValueError(
            f"fused_fft: unsupported (n={n}, in_len={in_len}); need "
            f"power-of-two n with n2={n2} >= 128 and in_len % n2 == 0")
    return n, n if out_len is None else min(out_len, n)


def fft_fused_plain(zr: torch.Tensor, zi: torch.Tensor, sign: int = -1,
                    n: int | None = None, out_len: int | None = None,
                    precision: str = "high"):
    """Plain version of K10: ``torch.fft.fft`` of the zero-padded complex
    rows for sign -1, the unscaled ``torch.fft.ifft`` (``norm="forward"``)
    for +1, the first ``out_len`` outputs. Returns (yr, yi)."""
    n, out_len = _shape(zr, zi, n, out_len, precision)
    z = torch.complex(zr.to(torch.float32), zi.to(torch.float32))
    if sign < 0:
        y = torch.fft.fft(z, n=n, dim=-1)
    else:
        y = torch.fft.ifft(z, n=n, dim=-1, norm="forward")
    y = y[:, :out_len]
    return y.real.contiguous(), y.imag.contiguous()


def fft_fused_cuda(zr: torch.Tensor, zi: torch.Tensor, sign: int = -1,
                   n: int | None = None, out_len: int | None = None,
                   precision: str = "high"):
    """Launch K10 on the current stream. zr and zi may be row-strided views
    (the channels of a (B, 2, T) signal) with unit stride along a row."""
    global launches
    lib = _build.load("fused_fft")
    n, out_len = _shape(zr, zi, n, out_len, precision)
    if n > _MAX_N:
        raise ValueError(f"the fused_fft kernel takes n <= {_MAX_N}, got {n}")
    if sign not in (1, -1):
        raise ValueError(f"sign must be -1 or +1, got {sign}")
    dev = zr.device
    for t in (zr, zi):
        if (t.device.type != "cuda" or t.device != dev
                or t.dtype != torch.float32 or t.stride(1) != 1
                or (zr.shape[0] > 1 and t.stride(0) != zr.stride(0))):
            raise ValueError(
                "fft_fused takes two float32 CUDA (B, in_len) arrays on one "
                "device with unit stride along a row and one row stride, "
                f"got {t.device} {t.dtype} strides {t.stride()}")
    B, in_len = zr.shape
    in_stride = zr.stride(0) if B > 1 else in_len
    if in_stride < in_len:
        raise ValueError(f"fft_fused rows overlap: row stride {in_stride} < "
                         f"in_len {in_len}")
    n1, n2 = _radix(n)
    yr = torch.empty((B, out_len), dtype=torch.float32, device=dev)
    yi = torch.empty_like(yr)
    counters = torch.empty(1 + 2 * B, dtype=torch.int32, device=dev)
    fn = lib.fft_fused_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                   + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(zr.data_ptr(), zi.data_ptr(), in_stride,
             yr.data_ptr(), yi.data_ptr(),
             _scratch(n, scratch_slots(), dev).data_ptr(),
             _twiddles(n1, dev).data_ptr(), _roots(n, dev).data_ptr(),
             counters.data_ptr(), B, in_len, n1, n2, out_len, sign,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fft_fused_launch failed: CUDA error {err}")
    launches += 1
    return yr, yi


def fft_fused(zr: torch.Tensor, zi: torch.Tensor, sign: int = -1,
              n: int | None = None, out_len: int | None = None,
              precision: str = "high"):
    """Batched complex DFT: zr/zi (B, in_len) float32, in_len <= n an
    implicit zero pad and a multiple of n2 = n/n1; sign -1 forward, +1
    inverse (unscaled); ``out_len`` keeps only the first outputs. Returns
    (yr, yi), each (B, min(out_len, n))."""
    if zr.device.type == "cpu":
        return fft_fused_plain(zr, zi, sign, n, out_len, precision)
    return fft_fused_cuda(zr, zi, sign, n, out_len, precision)
