"""ctypes binding of the native data-loading engine (``csrc/stito_io.cpp``)
— port of ``st_ito_tpu/native/io.py``: FLAC info, decode and encode, the
tar index, npz members read in place, and the fused multithreaded shard
decoder (shuffle, crop, float16 -> float32, gain, LR flip) that releases
the GIL.

The library is built with the JAX package's g++ line into
``build/st_ito_torch_io/``, named by a hash of the source, and written
under a temporary name first: processes that build it side by side never
load a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import io as _io
import os
import subprocess
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "csrc" / "stito_io.cpp"
BUILD_DIR = _ROOT / "build" / "st_ito_torch_io"
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_LIBS = ["-lz", "-lpthread"]

_LIB = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(_FLAGS + _LIBS).encode())
    return BUILD_DIR / f"libstito_io-{digest.hexdigest()[:12]}.so"


def load_io_library() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    lib_path = library_path()
    if not lib_path.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(SOURCE), *_LIBS],
                       check=True, capture_output=True)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    c = ctypes
    lib.stito_flac_info.restype = c.c_int
    lib.stito_flac_info.argtypes = [
        c.c_char_p, c.c_int64, c.POINTER(c.c_int), c.POINTER(c.c_int),
        c.POINTER(c.c_int), c.POINTER(c.c_int64)]
    lib.stito_flac_decode.restype = c.c_int64
    lib.stito_flac_decode.argtypes = [
        c.c_char_p, c.c_int64, c.POINTER(c.c_float), c.c_int64,
        c.POINTER(c.c_int), c.POINTER(c.c_int)]
    lib.stito_flac_encode.restype = c.c_int64
    lib.stito_flac_encode.argtypes = [
        c.POINTER(c.c_int32), c.c_int64, c.c_int, c.c_int, c.c_int, c.c_int,
        c.POINTER(c.c_uint8), c.c_int64]
    lib.stito_tar_index.restype = c.c_int64
    lib.stito_tar_index.argtypes = [
        c.c_char_p, c.c_char_p, c.POINTER(c.c_int64), c.POINTER(c.c_int64),
        c.c_int64]
    lib.stito_npz_member.restype = c.c_int64
    lib.stito_npz_member.argtypes = [
        c.c_char_p, c.c_char_p, c.POINTER(c.c_uint8), c.c_int64]
    lib.stito_decode_shard.restype = c.c_int
    lib.stito_decode_shard.argtypes = [
        c.POINTER(c.c_uint16), c.c_int64, c.c_int64, c.c_int64,
        c.POINTER(c.c_int64), c.POINTER(c.c_int64), c.POINTER(c.c_float),
        c.POINTER(c.c_uint8), c.c_int64, c.POINTER(c.c_float), c.c_int]
    _LIB = lib
    return lib


def io_available() -> bool:
    try:
        load_io_library()
        return True
    except (OSError, subprocess.CalledProcessError, FileNotFoundError):
        return False


def flac_info(data: bytes):
    """(sample_rate, channels, bits_per_sample, total_samples)."""
    lib = load_io_library()
    sr = ctypes.c_int()
    chs = ctypes.c_int()
    bps = ctypes.c_int()
    total = ctypes.c_int64()
    rc = lib.stito_flac_info(data, len(data), ctypes.byref(sr),
                             ctypes.byref(chs), ctypes.byref(bps),
                             ctypes.byref(total))
    if rc != 0:
        raise ValueError(f"not a FLAC stream (code {rc})")
    return sr.value, chs.value, bps.value, total.value


def flac_decode(data: bytes):
    """FLAC bytes -> (audio (channels, frames) float32 in [-1, 1), sr)."""
    lib = load_io_library()
    _, chs, _, total = flac_info(data)
    if total <= 0:
        total = len(data) * 4  # unset in STREAMINFO: over-allocate
    out = np.empty((total, chs), np.float32)
    sr = ctypes.c_int()
    chs_out = ctypes.c_int()
    n = lib.stito_flac_decode(
        data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        total, ctypes.byref(sr), ctypes.byref(chs_out))
    if n < 0:
        raise ValueError(f"FLAC decode failed (code {n})")
    return np.ascontiguousarray(out[:n].T), sr.value


def flac_encode(audio: np.ndarray, sample_rate: int, mode: int = 1) -> bytes:
    """audio (channels, frames) float32 in [-1, 1] -> 16-bit FLAC bytes.
    mode: 0 verbatim, 1 fixed+rice, 2 mid/side fixed, 3 LPC test frames."""
    lib = load_io_library()
    chs, frames = audio.shape
    pcm = np.clip(np.round(audio.T * 32767.0), -32768, 32767).astype(np.int32)
    pcm = np.ascontiguousarray(pcm)
    cap = frames * chs * 4 + 16384
    out = np.empty(cap, np.uint8)
    n = lib.stito_flac_encode(
        pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), frames, chs,
        int(sample_rate), 16, mode,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if n < 0:
        raise ValueError(f"encode buffer too small (need {-n})")
    return out[:n].tobytes()


def tar_index(path: str):
    """[(member_name, data_offset, size), ...] for regular files."""
    lib = load_io_library()
    max_n = max(64, os.path.getsize(path) // 1024)
    names = ctypes.create_string_buffer(256 * max_n)
    offsets = np.empty(max_n, np.int64)
    sizes = np.empty(max_n, np.int64)
    n = lib.stito_tar_index(
        path.encode(), names,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), max_n)
    if n < 0:
        raise OSError(f"cannot scan tar {path}")
    out = []
    for i in range(n):
        name = names.raw[i * 256:(i + 1) * 256].split(b"\0", 1)[0]
        out.append((name.decode(), int(offsets[i]), int(sizes[i])))
    return out


def npz_member(path: str, name: str) -> np.ndarray:
    """Read one member of an .npz through the native zip reader."""
    lib = load_io_library()
    cap = 1 << 20
    for _ in range(2):
        buf = np.empty(cap, np.uint8)
        n = lib.stito_npz_member(
            path.encode(), name.encode(),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
        if n >= 0:
            return np.load(_io.BytesIO(buf[:n].tobytes()))
        if n == -1:
            raise KeyError(f"{name} not in {path}")
        cap = -n  # retry with the required capacity
    raise OSError(f"npz read failed for {path}:{name}")


class ByteScratch:
    """Growable reusable byte buffer (numpy views pin a bytearray against
    in-place resize, so growth swaps in a fresh allocation instead)."""

    def __init__(self, size: int = 1 << 20):
        self.buf = bytearray(size)

    def ensure(self, size: int) -> None:
        if len(self.buf) < size:
            self.buf = bytearray(size)


def _array_header(bio) -> tuple:
    """(shape, fortran_order, dtype) of a .npy header, by numpy's public
    readers (``np.savez`` writes format 1.0, or 2.0 for a long header;
    numpy releases differ in their private helpers)."""
    import numpy.lib.format as npf

    version = npf.read_magic(bio)
    if version == (1, 0):
        return npf.read_array_header_1_0(bio)
    if version == (2, 0):
        return npf.read_array_header_2_0(bio)
    raise ValueError(f"npy format {version} is not read in place")


def npz_member_into(path: str, name: str, scratch: ByteScratch) -> np.ndarray:
    """Read an npz member through the native zip reader into a REUSED
    scratch and return a zero-copy ndarray view into it (valid until the
    scratch is reused). Avoids the two fresh allocations per member of
    the np.load path and their first-touch page faults."""
    lib = load_io_library()
    for _ in range(2):
        buf = np.frombuffer(scratch.buf, np.uint8)
        n = lib.stito_npz_member(
            path.encode(), name.encode(),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(scratch.buf))
        if n >= 0:
            break
        if n == -1:
            raise KeyError(f"{name} not in {path}")
        del buf
        scratch.ensure(-n)
    else:
        raise OSError(f"npz read failed for {path}:{name}")
    bio = _io.BytesIO(buf[:1024].tobytes())
    shape, fortran, dtype = _array_header(bio)
    offset = bio.tell()
    count = int(np.prod(shape)) if shape else 1
    arr = np.frombuffer(scratch.buf, dtype=dtype, count=count, offset=offset)
    return arr.reshape(shape, order="F" if fortran else "C")


def decode_shard(
    data_f16: np.ndarray,
    starts: np.ndarray,
    gains: np.ndarray | None,
    flips: np.ndarray | None,
    crop_len: int,
    nthreads: int = 4,
    order: np.ndarray | None = None,
    out: np.ndarray | None = None,
) -> np.ndarray:
    """Fused shuffle + crop + f16->f32 widen + gain + LR flip over a whole
    shard. data_f16: (n, chs, T) float16; order optionally permutes
    examples during the decode. Runs in C++ with the GIL released.

    Pass a reused ``out`` buffer where possible: a fresh allocation per
    shard costs first-touch page faults on top of the decode."""
    lib = load_io_library()
    n, chs, T = data_f16.shape
    data_f16 = np.ascontiguousarray(data_f16)
    starts = np.ascontiguousarray(starts, np.int64)
    if out is None:
        out = np.empty((n, chs, crop_len), np.float32)
    else:
        assert out.shape == (n, chs, crop_len) and out.dtype == np.float32
    order_arr = (np.ascontiguousarray(order, np.int64)
                 if order is not None else None)
    o_ptr = (order_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
             if order_arr is not None else None)
    # hold converted arrays in locals: ctypes pointers into temporaries
    # would dangle before the call
    g_arr = (np.ascontiguousarray(gains, np.float32)
             if gains is not None else None)
    f_arr = (np.ascontiguousarray(flips, np.uint8)
             if flips is not None else None)
    g_ptr = (g_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
             if g_arr is not None else None)
    f_ptr = (f_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
             if f_arr is not None else None)
    rc = lib.stito_decode_shard(
        data_f16.view(np.uint16).ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint16)),
        n, chs, T, o_ptr,
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        g_ptr, f_ptr, crop_len,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nthreads)
    if rc != 0:
        raise ValueError("decode_shard failed (crop_len > T?)")
    return out
