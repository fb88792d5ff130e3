"""Time K3 (``csrc/mega_fft.cu fwd_pack_fft_response_launch``) stage by
stage at the ``mega2`` path's headline: B 512, stereo T 2^18, n 2^19, the
delay + reverb stages of ``chip_smoke.py rp_stage_case``; beside it K5, K2
and their sum, and K10's forward on the same transform.

    python3 -m st_ito_torch.tools.k3_stages [--reps 5] [--variants NAME,...]
        [--rounds 1]

The kernel's stage argument selects its timing probes: pass 1 alone, then
pass 1 with pass 2 emitting Z (K5's pass 2), Z plus the bins' Freeverb
values alone (the allpass loads and the phasors' factor products), and
the whole response epilogue. Each
probe's time less pass 1's is that pass 2's. ``--variants`` builds copies
of ``mega_fft.cu`` and the headers under ``build/k3_variants/`` with other
code (``VARIANTS``) and times K3 and K5 with each, all builds in turn
``rounds`` times over. CUDA events around
``reps`` launches after a warm-up. Needs a card.
"""

import argparse
import ctypes
import math
import shutil
import subprocess

import numpy as np
import torch

import chip_smoke as cs
from st_ito_torch.ops.kernels import _build
from st_ito_torch.ops.kernels import fused_fft as ff
from st_ito_torch.ops.kernels import mega_fft as mf
from st_ito_torch.ops.kernels import packed_response as k9

N, B, T = 2 ** 19, 512, 2 ** 18
# name -> (file, the text, what it becomes)
VARIANTS = {
    # one block an SM: the forward no longer held to 128 registers; and
    # with the scratch stored and read with the streaming cache hint
    "mb1": [("mega_fft.cu", "constexpr int kForwardMinBlocks = 2;",
             "constexpr int kForwardMinBlocks = 1;")],
    "mb1_cs": [("mega_fft.cu", "constexpr int kForwardMinBlocks = 2;",
                "constexpr int kForwardMinBlocks = 1;"),
               ("fft_persist.cuh",
                "m[((long long)k1 << sp.log_n2) + j2] = cmul(s[c * pitch + "
                "sw(q)], w);",
                "__stcs(m + ((long long)k1 << sp.log_n2) + j2, "
                "cmul(s[c * pitch + sw(q)], w));"),
               ("mega_fft.cu", "__ldcg(slot + ((long long)k1",
                "__ldcs(slot + ((long long)k1")],
    # at most three butterfly layers a step in K3's forward: less code
    "l3": [("mega_fft.cu", "fftpersist::cols_tile<false, 5>(",
            "fftpersist::cols_tile<false, 3>("),
           ("mega_fft.cu", "fft_rows_dif_wide<false, false, 5>(s, slots,",
            "fft_rows_dif_wide<false, false, 3>(s, slots,")],
    # the response math out of line, called once a (candidate, bin)
    "noinline": [("rp_response.cuh",
                  "__device__ __forceinline__ Coeffs rp_coeffs(",
                  "__device__ __noinline__ Coeffs rp_coeffs(")],
    # three blocks an SM (85 registers), with at most four butterfly
    # layers a step or five
    "mb3_l4": [("mega_fft.cu", "constexpr int kForwardMinBlocks = 2;",
                "constexpr int kForwardMinBlocks = 3;"),
               ("mega_fft.cu", "fftpersist::cols_tile<false, 5>(",
                "fftpersist::cols_tile<false, 4>("),
               ("mega_fft.cu", "fft_rows_dif_wide<false, false, 5>(s, slots,",
                "fft_rows_dif_wide<false, false, 4>(s, slots,")],
    "mb3": [("mega_fft.cu", "constexpr int kForwardMinBlocks = 2;",
             "constexpr int kForwardMinBlocks = 3;")],
    # no contraction of a*b + c into fused multiply-adds (-fmad=false, as
    # the other kernels build)
    "nofmad": [],
    # no allpass loads at all (wrong values): the most any layout of them
    # could save
    "ap_const": [("mega_fft.cu",
                  "make_float2(fac.ap[k], fac.ap[pitch_ap + k]),",
                  "make_float2(0.5f, 0.25f),"),
                 ("mega_fft.cu", "make_float2(fac.ap[2 * pitch_ap + k], "
                  "fac.ap[3 * pitch_ap + k])};",
                  "make_float2(0.5f, -0.25f)};")],
}


def build_variants(names) -> dict:
    """Build the named VARIANTS at once; name -> the loaded library."""
    out = _build.BUILD_DIR.parent / "k3_variants"
    procs = {}
    for name in names:
        subs = VARIANTS[name]
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for f in list(_build.CSRC.glob("*.cuh")) + [_build.CSRC
                                                    / "mega_fft.cu"]:
            shutil.copy(f, d / f.name)
        for f, old, new in subs:
            text = (d / f).read_text()
            if old not in text:
                raise RuntimeError(f"{name}: no {old!r} in {f}")
            (d / f).write_text(text.replace(old, new))
        procs[name] = subprocess.Popen(
            [_build._nvcc()] + _build._ARCH + _build._COMMON
            + _build.KERNELS["mega_fft"][1]
            + (["-fmad=false"] if name == "nofmad" else [])
            + ["-o", str(d / "libmega_fft.so"),
               str(d / "mega_fft.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        regs = [line.split(":")[-1].strip() for line in log.splitlines()
                if "registers" in line or "spill" in line]
        print(f"variant {name}: nvcc {proc.returncode}; " + " | ".join(regs),
              flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        libs[name] = ctypes.CDLL(str(out / name / "libmega_fft.so"))
    return libs
PROBES = ("pass 1 alone", "pass 1 + pass 2 emitting Z",
          "pass 1 + pass 2 with the Freeverb values alone",
          "pass 1 + pass 2 with the whole epilogue")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--variants", default="",
                        help="comma-separated VARIANTS to build and time "
                        "too")
    parser.add_argument("--rounds", type=int, default=1,
                        help="times over which to time the builds in turn")
    args = parser.parse_args()
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    rng = np.random.default_rng(30)
    x = rng.standard_normal((B, 2, T)).astype(np.float32)
    x = torch.from_numpy(x / np.abs(x).max()).to(dev)
    stages = cs.rp_stage_case(B, rng, dev)
    tables = k9.rp_tables(["delay", "reverb"], cs.SR, N, dev)
    F = N // 2 + 1

    times = {}
    for stage, name in enumerate(PROBES):
        times[name] = cs.cuda_ms(lambda: mf.fwd_pack_fft_response_cuda(
            x, stages, N, tables, stage=stage), args.reps)
    times["K3"] = cs.cuda_ms(
        lambda: mf.fwd_pack_fft_response_cuda(x, stages, N, tables),
        args.reps)
    p1 = times[PROBES[0]]
    for name in PROBES + ("K3",):
        extra = "" if name == PROBES[0] else f" (less pass 1: " \
            f"{times[name] - p1!r} ms)"
        print(f"K3 {name}: {times[name]!r} ms{extra}", flush=True)

    ref = mf.fwd_pack_fft_response_cuda(x, stages, N, tables)
    builds = {"this build": _build.load("mega_fft")}
    if args.variants:
        builds.update(build_variants(args.variants.split(",")))
    for _ in range(args.rounds):
        for label, lib in builds.items():
            _build._LIBS["mega_fft"] = lib  # the wrappers launch this build
            k5 = cs.cuda_ms(lambda: mf.fwd_pack_fft_cuda(x, N), args.reps)
            k3 = cs.cuda_ms(lambda: mf.fwd_pack_fft_response_cuda(
                x, stages, N, tables), args.reps)
            err, _ = cs.rel_err(mf.fwd_pack_fft_response_cuda(
                x, stages, N, tables), ref, F)
            print(f"{label}: K5 {k5!r} ms, K3 {k3!r} ms, max |K3 - this "
                  f"build's| {err!r}", flush=True)
    _build._LIBS["mega_fft"] = builds["this build"]
    del ref

    Z = mf.fwd_pack_fft_cuda(x, N)
    k5 = cs.cuda_ms(lambda: mf.fwd_pack_fft_cuda(x, N), args.reps)
    k2 = cs.cuda_ms(lambda: k9.packed_response_padded_cuda(
        *Z, stages, tables, N), args.reps)
    print(f"K5 {k5!r} ms, K2 {k2!r} ms, K5 + K2 {k5 + k2!r} ms", flush=True)
    want = k9.packed_response_padded_cuda(*Z, stages, tables, N)
    got = mf.fwd_pack_fft_response_cuda(x, stages, N, tables)
    err, rel = cs.rel_err(got, want, F)
    print(f"max |K3 - K2(K5)| {err!r}, relative {rel!r}", flush=True)
    del Z, want, got
    torch.cuda.empty_cache()
    k10 = cs.cuda_ms(lambda: ff.fft_fused_cuda(x[:, 0], x[:, 1], sign=-1,
                                               n=N), args.reps)
    print(f"K10 forward on the same transform (planar, no half grids): "
          f"{k10!r} ms", flush=True)
    for name, text in _build.BUILD_LOGS.items():  # what this run built
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    table_gb = 4 * tables["reverb"]["_packed"].numel() / 1e9
    print(f"the Freeverb table: {table_gb!r} GB; gathered once per "
          f"(candidate, bin): {table_gb * B!r} GB; ideal bytes of K3 "
          f"{4 * (2 * B * T + 4 * B * F) / 1e9 + table_gb!r} GB "
          f"(log2 n {int(math.log2(N))})", flush=True)


if __name__ == "__main__":
    main()
