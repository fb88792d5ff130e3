"""Time K4 (``csrc/mega_fft.cu inv_unpack_fft_launch``), K2 and K9
(``csrc/packed_response.cu``) stage by stage at the ``mega`` path's
headline: B 512, stereo T 2^18, n 2^19, the delay + reverb stages of
``chip_smoke.py rp_stage_case``.

    python3 -m st_ito_torch.tools.k4_stages [--reps 10] [--variants NAME,...]
        [--parent DIR] [--rounds 2]

K4's stage argument: -1 the kernel, 0 its first pass alone. K2's and K9's:
-1 the kernel, 0 the loads and stores alone (Y = Z, the bytes floor), 1
the response with IEEE division and cosf/sinf (``rp_response.cuh
IeeeMath``), 2 with the approximate divide and one sincosf (``FastMath``).
Each response probe's output is held against the IEEE probe's (relative
to max|Y|), on the headline and on the delay's comb resonances (``chip_smoke.py
resonant_stage_case``, n 2^19, B 64), so that a probe's time comes with
what its arithmetic gives. ``--variants`` builds copies of a source
(``packed_response.cu`` or ``mega_fft.cu``) and the headers under
``build/k4_variants/`` with other flags or code (``VARIANTS``) and times
K4, or K2's and K9's probes, with each. ``--parent DIR`` builds
``mega_fft.cu``, ``fused_fft.cu`` and ``packed_response.cu`` from another
checkout (e.g. ``git archive`` of the parent commit) and, at the headline,
holds this checkout's K10 (forward and inverse), K5 and K3 to them bit for
bit, and times those and K4, K2 and K9 against the other checkout's in
turns (other, this, this, other, ``rounds`` times); it exits non-zero if a
kernel that should be bitwise is not. CUDA events around ``reps`` launches after a
warm-up; beside them K10's inverse and cuFFT's on the same transform.
Needs a card.
"""

import argparse
import ctypes
import math
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from st_ito_torch.ops.kernels import _build
from st_ito_torch.ops.kernels import fused_fft as ff
from st_ito_torch.ops.kernels import mega_fft as mf
from st_ito_torch.ops.kernels import packed_response as k9

N, B, T = 2 ** 19, 512, 2 ** 18
F = N // 2 + 1
# name -> (the library, nvcc flags in place of the build's, [(file, the
# text, what it becomes)])
VARIANTS = {
    # K2 and K9 without nvcc's contraction of a*b + c into fused
    # multiply-adds (-fmad=false, as the scans build)
    "nofmad": ("packed_response", ["-fmad=false"], []),
    # K2 and K9 with the bin tiles, not the candidate chunks, the fastest
    # axis of the grid
    "bins_fast": ("packed_response", [], [
        ("packed_response.cu",
         "const int b_begin = blockIdx.x * kCandPerBlock;",
         "const int b_begin = blockIdx.y * kCandPerBlock;"),
        ("packed_response.cu",
         "const int k = blockIdx.y * kThreads + threadIdx.x;",
         "const int k = blockIdx.x * kThreads + threadIdx.x;"),
        ("packed_response.cu",
         "const dim3 grid((B + kCandPerBlock - 1) / kCandPerBlock,\n"
         "                  (F + kThreads - 1) / kThreads);",
         "const dim3 grid((F + kThreads - 1) / kThreads,\n"
         "                  (B + kCandPerBlock - 1) / kCandPerBlock);")]),
    # K4 with at most five butterfly layers a step (K10's forward takes 5)
    "k4_l5": ("mega_fft", [], [("mega_fft.cu",
                                "constexpr int kInverseLayers = 4;",
                                "constexpr int kInverseLayers = 5;")]),
}
PR_PROBES = {0: "loads and stores alone", 1: "IEEE response",
             2: "FastMath response"}


def build_variants(names) -> dict:
    """Build the named VARIANTS at once; name -> (library name, the loaded
    library)."""
    out = _build.BUILD_DIR.parent / "k4_variants"
    procs = {}
    for name in names:
        lib, flags, subs = VARIANTS[name]
        src = _build.KERNELS[lib][0]
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for f in list(_build.CSRC.glob("*.cuh")) + [_build.CSRC / src]:
            shutil.copy(f, d / f.name)
        for f, old, new in subs:
            text = (d / f).read_text()
            if old not in text:
                raise RuntimeError(f"{name}: no {old!r} in {f}")
            (d / f).write_text(text.replace(old, new))
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc()] + _build._ARCH + _build._COMMON + flags
            + ["-o", str(d / f"lib{lib}.so"), str(d / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        print(f"variant {name}: nvcc {proc.returncode}; "
              + " | ".join(registers(log)), flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        libs[name] = (lib, ctypes.CDLL(str(out / name / f"lib{lib}.so")))
    return libs


def registers(log):
    return [line.split(":")[-1].strip() for line in log.splitlines()
            if "registers" in line or "spill" in line]


def k2_k9_runs(Z, Zp, tables):
    """name -> (launch(spectra, stages, stage), headline spectra, resonance
    spectra) for K9 (flat) and K2 (pitched)."""
    return {"K9": (lambda z, st, stage: k9.packed_response_cuda(
                *z, st, tables, stage=stage), Z[0], Z[1]),
            "K2": (lambda z, st, stage: k9.packed_response_padded_cuda(
                *z, st, tables, N, stage=stage), Zp[0], Zp[1])}


def k2_k9_probes(label, runs, stages, rst, wants, reps):
    """Every probe's time for K9 and K2, and each response probe's error
    against ``wants`` (the IEEE build's outputs, which equal the plain
    version's), on the headline and on the resonances (stages ``rst``)."""
    for name, (run, zs, rz) in runs.items():
        ms = {s: cs.cuda_ms(lambda s=s: run(zs, stages, s), reps)
              for s in (-1, 0, 1, 2)}
        errs = {s: (cs.rel_err(run(zs, stages, s), wants[name][0], F)[1],
                    cs.rel_err(run(rz, rst, s), wants[name][1], F)[1])
                for s in (-1, 1, 2)}
        print(f"{label} {name}: kernel {ms[-1]!r} ms; "
              + "; ".join(f"{PR_PROBES[s]} {ms[s]!r} ms" for s in (0, 1, 2))
              + "; relative error against IEEE arithmetic (headline, "
              f"resonances): kernel {errs[-1]}, IEEE {errs[1]}, FastMath "
              f"{errs[2]}", flush=True)
        torch.cuda.empty_cache()


def build_other(root: str) -> dict:
    """name -> the library built from checkout ``root``'s source of each of
    mega_fft, fused_fft and packed_response, with that checkout's flags
    (its ``_build.KERNELS``)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "other_build", Path(root) / "st_ito_torch" / "ops" / "kernels"
        / "_build.py")
    other_build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other_build)
    out = _build.BUILD_DIR.parent / "k4_parent"
    procs = {}
    for name in ("mega_fft", "fused_fft", "packed_response"):
        src, flags = other_build.KERNELS[name]
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        csrc = Path(root) / "st_ito_torch" / "csrc"
        for f in list(csrc.glob("*.cuh")) + [csrc / src]:
            shutil.copy(f, d / f.name)
        procs[name] = subprocess.Popen(
            [_build._nvcc()] + _build._ARCH + _build._COMMON + flags
            + ["-o", str(d / f"lib{name}.so"), str(d / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{root}: {name} failed to build\n{log}")
        libs[name] = ctypes.CDLL(str(out / name / f"lib{name}.so"))
    return libs


def other_k4(lib, Y):
    """K4 of a checkout whose entry still takes chunks of 64 candidates
    through a scratch of its own (the C interface before the persistent
    launch)."""
    n1, n2 = mf._radix(N)
    dev = Y[0].device
    scratch = mf._scratch(N, 64, dev)
    y = torch.empty((B, 2, T), dtype=torch.float32, device=dev)
    fn = lib.inv_unpack_fft_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(*(v.data_ptr() for v in Y), y.data_ptr(), scratch.data_ptr(),
             mf._twiddles(n1, dev).data_ptr(), B, T, n1, n2,
             Y[0].shape[1] * n1, 64, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"the other K4 failed: CUDA error {err}")
    return y


def other_response(lib, Z, stages, tables, pitch):
    """K9 (pitch None) or K2 of a checkout whose entries take no stage
    argument (the C interface before the probes)."""
    Bz, dev = Z[0].shape[0], Z[0].device
    codes, n_stages, prm, act, table, sr = k9.stage_args(stages, Bz, F,
                                                         tables, dev)
    outs = [torch.empty_like(Z[0]) for _ in range(4)]
    fn = getattr(lib, "packed_response_launch" if pitch is None
                 else "packed_response_padded_launch")
    fn.argtypes = ([ctypes.c_void_p] * 8
                   + [ctypes.c_uint, ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * (3 if pitch is None else 4)
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    dims = (Bz, F, N) if pitch is None else (Bz, F, pitch, N)
    err = fn(*(z.data_ptr() for z in Z), *(o.data_ptr() for o in outs),
             codes, n_stages, prm.data_ptr(), k9.data_ptr(act),
             k9.data_ptr(table), *dims, 2.0 * math.pi / N, sr,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"the other K2/K9 failed: CUDA error {err}")
    return outs


def in_turns(run_other, run_this, rounds, reps):
    """(other's times, this one's) in ms: other, this, this, other, rounds
    times over."""
    times = {"other": [], "this": []}
    for _ in range(rounds):
        for who in ("other", "this", "this", "other"):
            times[who].append(cs.cuda_ms(
                run_other if who == "other" else run_this, reps))
    return times["other"], times["this"]


def against_other(root, x, stages, tables, Zp, rounds, reps, dev) -> bool:
    """K10, K5, K3 bit for bit, and all six in turns, against checkout
    ``root``'s builds; True when the bitwise ones are equal."""
    other = build_other(root)
    this = {name: _build.load(name) for name in other}

    def swap(libs):
        for name, lib in libs.items():
            _build._LIBS[name] = lib

    def swapped(libs, run):
        def fn():
            swap(libs)
            return run()
        return fn

    same = True
    zc = [x[:, 0].contiguous(), x[:, 1].contiguous()]
    zi = [torch.randn((B, N), device=dev) for _ in range(2)]
    # the half grids are compared on their F valid bins (the kernels leave
    # the rest as allocated)
    for name, run, cut in (
            ("K10 forward", lambda: ff.fft_fused_cuda(*zc, sign=-1, n=N),
             None),
            ("K10 inverse", lambda: ff.fft_fused_cuda(*zi, sign=1, n=N,
                                                      out_len=T), None),
            ("K5", lambda: mf.fwd_pack_fft_cuda(x, N), F),
            ("K3", lambda: mf.fwd_pack_fft_response_cuda(x, stages, N,
                                                         tables), F)):
        swap(other)
        want = run()
        swap(this)
        got = run()
        if cut is not None:
            got, want = ([v.reshape(B, -1)[:, :cut] for v in vs]
                         for vs in (got, want))
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        del want, got
        t_other, t_this = in_turns(swapped(other, run), swapped(this, run),
                                   rounds, reps)
        swap(this)
        print(f"{name} against {root}'s: bitwise {equal}; {root}'s "
              f"{t_other!r} ms, this checkout's {t_this!r} ms", flush=True)
        same = same and equal
    del zi
    torch.cuda.empty_cache()
    Z = [z.reshape(B, -1)[:, :F].contiguous() for z in Zp]
    Y = k9.packed_response_padded_cuda(*Zp, stages, tables, N)
    Rp = Zp[0].shape[1]
    pairs = {
        "K4": (lambda: other_k4(other["mega_fft"], Y),
               lambda: mf.inv_unpack_fft_cuda(*Y, N, T)),
        "K2": (lambda: other_response(other["packed_response"], Zp, stages,
                                      tables, Rp * Zp[0].shape[2]),
               lambda: k9.packed_response_padded_cuda(*Zp, stages, tables,
                                                      N)),
        "K9": (lambda: other_response(other["packed_response"], Z, stages,
                                      tables, None),
               lambda: k9.packed_response_cuda(*Z, stages, tables))}
    for name, (run_other, run_this) in pairs.items():
        t_other, t_this = in_turns(run_other, run_this, rounds, reps)
        err = cs.rel_err(run_this(), run_other(), F)[1]
        print(f"{name}: {root}'s {t_other!r} ms, this checkout's {t_this!r} "
              f"ms; relative difference {err!r}", flush=True)
        torch.cuda.empty_cache()
    return same


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--variants", default="",
                        help="comma-separated VARIANTS to build and time "
                        "too")
    parser.add_argument("--parent", help="a checkout to hold K10, K5 and "
                        "K3 to bit for bit and to time K4, K2 and K9 "
                        "against")
    parser.add_argument("--rounds", type=int, default=2,
                        help="rounds of turns against --parent")
    args = parser.parse_args()
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    _build.build(["mega_fft", "packed_response", "fused_fft"])
    rng = np.random.default_rng(31)
    x = rng.standard_normal((B, 2, T)).astype(np.float32)
    x = torch.from_numpy(x / np.abs(x).max()).to(dev)
    stages = cs.rp_stage_case(B, rng, dev)
    tables = k9.rp_tables(["delay", "reverb"], cs.SR, N, dev)

    variants = build_variants(args.variants.split(",")) if args.variants \
        else {}
    Zp = mf.fwd_pack_fft_cuda(x, N)
    Y = k9.packed_response_padded_cuda(*Zp, stages, tables, N)
    want = mf.inv_unpack_fft_cuda(*Y, N, T)
    builds = {"this build": ("mega_fft", _build.load("mega_fft"))}
    builds.update({k: v for k, v in variants.items() if v[0] == "mega_fft"})
    for label, (_, lib) in builds.items():
        _build._LIBS["mega_fft"] = lib  # the wrappers launch this build
        k4 = {s: cs.cuda_ms(lambda s=s: mf.inv_unpack_fft_cuda(
            *Y, N, T, stage=s), args.reps) for s in (-1, 0)}
        err = cs.rel_err([mf.inv_unpack_fft_cuda(*Y, N, T)], [want])[1]
        print(f"{label} K4: kernel {k4[-1]!r} ms, first pass alone "
              f"{k4[0]!r} ms (the rest {k4[-1] - k4[0]!r} ms); relative "
              f"to this build's {err!r}", flush=True)
    _build._LIBS["mega_fft"] = builds["this build"][1]
    lib = cs.cuda_ms(lambda: cs.lib_inv(Y, N, T), args.reps)
    print(f"torch.fft.ifft with its glue {lib!r} ms", flush=True)
    del Y, want
    torch.cuda.empty_cache()
    zc = [torch.randn((B, N), device=dev) for _ in range(2)]
    k10 = cs.cuda_ms(lambda: ff.fft_fused_cuda(*zc, sign=1, n=N, out_len=T),
                     args.reps)
    print(f"K10's inverse on the same transform (planar, out_len T): "
          f"{k10!r} ms", flush=True)
    del zc
    torch.cuda.empty_cache()

    Z = [z.reshape(B, -1)[:, :F].contiguous() for z in Zp]
    rrng = np.random.default_rng(32)
    Br = 64
    xr = rrng.standard_normal((Br, 2, T)).astype(np.float32)
    xr = torch.from_numpy(xr / np.abs(xr).max()).to(dev)
    rst = cs.resonant_stage_case(Br, rrng, dev)
    Zrp = mf.fwd_pack_fft_cuda(xr, N)
    Zr = [z.reshape(Br, -1)[:, :F].contiguous() for z in Zrp]
    runs = k2_k9_runs((Z, Zr), (Zp, Zrp), tables)
    wants = {name: (run(zs, stages, 1), run(rz, rst, 1))
             for name, (run, zs, rz) in runs.items()}
    builds = {"this build": ("packed_response",
                             _build.load("packed_response"))}
    builds.update({k: v for k, v in variants.items()
                   if v[0] == "packed_response"})
    for label, (_, lib) in builds.items():
        _build._LIBS["packed_response"] = lib  # the wrappers launch this
        k2_k9_probes(label, runs, stages, rst, wants, args.reps)
    _build._LIBS["packed_response"] = builds["this build"][1]
    for name, text in _build.BUILD_LOGS.items():  # what this run built
        for line in registers(text):
            print(f"  {name}: {line}", flush=True)
    if args.parent and not against_other(args.parent, x, stages, tables, Zp,
                                         args.rounds, args.reps, dev):
        sys.exit(1)


if __name__ == "__main__":
    main()
