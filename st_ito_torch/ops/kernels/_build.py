"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source in ``st_ito_torch/csrc/`` compiles on first use into a shared
library with a plain C interface under ``build/st_ito_torch_kernels/`` at
the repository root (listed in ``.gitignore``). The library's file name
carries a hash of its source, of the headers beside it (``csrc/*.cuh``) and
of its flags, so an edited source or header rebuilds.
Nothing is compiled or loaded when a module is imported, so a machine
without ``nvcc`` or a card imports every module; the wrappers only come
here for a tensor that is not on the CPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "st_ito_torch_kernels"

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_COMMON = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v"]

# name -> (source, extra nvcc flags). eqcomp, fused_fft and scan build
# with -fmad=false: K11 then does the plain PyTorch version's arithmetic op
# for op (which never contracts a*b + c into one rounding), and so does
# each step of the chunked scans K1, K6, K7 and K8, whose first chunks
# match bitwise; with nvcc's default contraction K1 drifted past its 1e-4
# tolerance (PERF.md). The FFT kernels cannot match cuFFT bitwise either
# way. K10 keeps the flag; K5, K3 and K4 (mega_fft) and K9 and K2
# (packed_response) take nvcc's contraction, which made K3 3% and K2 9%
# faster on the card (PERF.md): the response math writes the delay's phase
# and denominator, where a comb resonance magnifies a rounding a
# thousandfold, with unfused rounded operations (rp_response.cuh
# delay_build).
KERNELS = {
    "eqcomp": ("eqcomp.cu", ["-fmad=false"]),
    "packed_response": ("packed_response.cu", []),
    "mega_fft": ("mega_fft.cu", []),
    "fused_fft": ("fused_fft.cu", ["-fmad=false"]),
    "scan": ("scan.cu", ["-fmad=false"]),
}

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the st_ito_torch CUDA kernels cannot be built here")


def _target(name: str) -> Path:
    src, extra = KERNELS[name]
    digest = hashlib.sha1((CSRC / src).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(_ARCH + _COMMON + extra).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names=None) -> dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet, one
    nvcc process per source, all started together. Returns name -> seconds
    taken by its compile (0.0 when it was already built); each compiler log
    (the ``-Xptxas -v`` register and spill report) lands in
    ``BUILD_LOGS``."""
    names = list(KERNELS) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    secs = {}
    for name in names:
        out = _target(name)
        if out.is_file():
            secs[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        src, extra = KERNELS[name]
        cmd = ([_nvcc()] + _ARCH + _COMMON + extra
               + ["-o", str(tmp), str(CSRC / src)])
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    errors = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The named kernel library, built first if needed. Raises when it
    cannot be built or loaded; the wrappers never fall back."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib
