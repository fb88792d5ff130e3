"""Time the chunked scans at several chunk lengths at their headline shapes:
K1 (``csrc/eqcomp.cu``, 1024 lanes x 262144 on the shared input of
``chip_smoke.py``'s ``k1`` phase), K6 (the same lanes on the shared input
of its ``scan`` phase), K8 (512 lanes), K7 (1024 lanes, with its bypass
row) and K11 (1024 lanes), the last four (``scan_core.cuh
run_chunked_linear`` and ``run_chunked_detector``, ``scan.cu
run_chunked_recurrence``) also stage by stage, with CUDA events between
the launches, so that the carries are timed apart from the passes.

    python3 -m st_ito_torch.tools.k1_chunks [--kernels k1,k6,k7,k8,k11]
                                             [--parent DIR]

The wrappers pick the chunk (``chunked.chunk_len``); here the libraries are
called directly with each length. For K1 the kernel is then held against
float32 and float64 runs of the plain version lane by lane, listing the
lanes farthest from rule (a) of ``eqcomp.gate_excess`` (the plain runs take
minutes: a Python loop over T). For K6, K7, K8 and K11 each length's output is
compared with the wrapper's (``chip_smoke.py`` holds that one to the plain
version). ``--parent DIR`` also builds K1 from another checkout's sources
(``DIR/st_ito_torch/csrc/eqcomp.cu`` with the headers beside it, e.g. from
``git archive`` of an earlier commit) and holds this checkout's K1 to it
bit for bit at B 37 x T 20011 (shared and per-candidate input) and at the
headline; it exits non-zero if they differ. Needs a card.
"""

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

import torch

import chip_smoke as cs
from st_ito_torch.ops.kernels import _build, eqcomp, scan

CHUNKS = (1024, 512, 2048, 256)
# the stages of run_chunked_linear (K6), run_chunked_detector (K7, K8) and
# run_chunked_recurrence (K11), by their stage argument
STAGES = {"k6": ("pass A", "carry", "pass D"),
          "k7": ("pass B", "carry 1", "pass C", "carry 2", "pass D")}
STAGES["k8"] = STAGES["k7"]
STAGES["k11"] = STAGES["k6"]


def k1_launch(args, L, lib=None):
    x, vec, S, with_dist, shared = args
    lanes, T = vec.shape[1], x.shape[-1]
    out = torch.empty((lanes, T), device=x.device)
    table = torch.empty((-(-T // L), eqcomp.table_rows(S), lanes),
                        device=x.device)
    fn = (lib or _build.load("eqcomp")).eqcomp_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_void_p]
    err = fn(x.data_ptr(), shared, vec.data_ptr(), out.data_ptr(),
             table.data_ptr(), lanes, T, S, int(with_dist), L,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"CUDA error {err}")
    return out


def sweep_k1():
    dev = torch.device("cuda")
    args = cs.k1_inputs(cs.POP, 2, cs.T_HEAD, 2, True, dev)
    vec, S, with_dist = args[1], args[2], args[3]
    for L in CHUNKS:
        ms = cs.cuda_ms(lambda: k1_launch(args, L), 3)
        print(f"K1 headline chunk {L}: {ms!r} ms", flush=True)
    got = eqcomp.eqcomp_cuda(*args)
    t0 = time.time()
    w32 = eqcomp.eqcomp_plain(*args)
    w64 = eqcomp.eqcomp_plain(*args, dtype=torch.float64)
    print(f"plain runs {time.time() - t0:.0f} s", flush=True)
    print("headline", eqcomp.gate_excess(got, w32, vec, S, with_dist,
                                         want64=w64), flush=True)
    bypassed = vec[5 * S + 10] == 0
    peak = torch.clamp_min(w32.abs().amax(1), 1)
    e32 = (w32.double() - w64).abs().amax(1)
    ek = (got.double() - w64).abs().amax(1)
    dk = (got - w32).abs().amax(1)
    for i in torch.argsort(-(dk / peak) * bypassed)[:12].tolist():
        print(f"lane {i}: |kernel - p32| {dk[i]:.3g}, |p32 - p64| "
              f"{e32[i]:.3g}, |kernel - p64| {ek[i]:.3g}, peak "
              f"{peak[i]:.3g}, eq {vec[5 * S, i]:.0f}, comp "
              f"{vec[5 * S + 7, i]:.0f}", flush=True)
    print("bypassed lanes where the float32 plain run lies past 1e-4 x peak "
          f"of the float64 one: {int(((e32 > 1e-4 * peak) & bypassed).sum())}"
          f" of {int(bypassed.sum())}", flush=True)


def k1_against_parent(parent: str) -> bool:
    """Build K1 from the checkout ``parent`` and compare this checkout's
    K1 with it bit for bit; True when every set is equal."""
    out = _build.BUILD_DIR.parent / "k1_parent"
    out.mkdir(parents=True, exist_ok=True)
    lib_path = out / "libeqcomp.so"
    subprocess.run([_build._nvcc()] + _build._ARCH + _build._COMMON
                   + ["-fmad=false", "-o", str(lib_path),
                      str(Path(parent) / "st_ito_torch" / "csrc"
                          / "eqcomp.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path.resolve()))
    dev = torch.device("cuda")
    same = True
    for label, args in (
            ("B 37, T 20011, shared", cs.k1_inputs(37, 2, 20011, 1, True,
                                                   dev)),
            ("B 37, T 20011, per-candidate",
             cs.k1_inputs(37, 2, 20011, 1, False, dev)),
            ("headline", cs.k1_inputs(cs.POP, 2, cs.T_HEAD, 2, True, dev))):
        L = eqcomp.chunk_len(args[1].shape[1], args[0].shape[-1])
        equal = torch.equal(k1_launch(args, L, lib), eqcomp.eqcomp_cuda(*args))
        print(f"K1 from {parent} against this checkout's, {label}: bitwise "
              f"{equal}", flush=True)
        same = same and equal
    return same


def scan_launch(name, args, L, stage, out, table):
    """One launch of K6 (``name`` "k6", args (x, vec, S, with_active,
    shared_channels)), K8 ("k8", args (c, vec)), K7 ("k7", args (x, vec,
    with_active)) or K11 ("k11", args (a, b)) in chunks of L, all stages
    (stage -1) or one."""
    if name == "k11":
        scan.linear_recurrence_launch(*args, out, table, L, stage)
        return
    lib = _build.load("scan")
    x, vec = args[0], args[1]
    lanes, T = vec.shape[1], x.shape[-1]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if name == "k6":
        fn = lib.biquad_cascade_launch
        fn.argtypes = [P, I, P, P, P, I, LL, I, I, LL, I, P]
        err = fn(x.data_ptr(), args[4], vec.data_ptr(), out.data_ptr(),
                 table.data_ptr(), lanes, T, args[2], int(args[3]), L, stage,
                 stream)
    elif name == "k8":
        fn = lib.ballistics_launch
        fn.argtypes = [P, P, P, P, I, LL, LL, I, P]
        err = fn(x.data_ptr(), vec.data_ptr(), out.data_ptr(),
                 table.data_ptr(), lanes, T, L, stage, stream)
    else:
        fn = lib.compressor_fused_launch
        fn.argtypes = [P, P, P, P, I, LL, I, LL, I, P]
        err = fn(x.data_ptr(), vec.data_ptr(), out.data_ptr(),
                 table.data_ptr(), lanes, T, int(args[2]), L, stage, stream)
    if err:
        raise RuntimeError(f"CUDA error {err}")


def sweep_scan(name, args, reps=5):
    """K6, K7, K8 or K11 at each of CHUNKS, whole and stage by stage."""
    x, vec = args[0], args[1]
    lanes, T = (x.shape[0] if name == "k11" else vec.shape[1]), x.shape[-1]
    if name == "k6":
        ref = scan.biquad_cascade_cuda(*args)
        want, rows = scan.cascade_chunk_len(lanes, T), scan.CASCADE_ROWS
    elif name == "k11":
        ref = scan.linear_recurrence_cuda(*args)
        want, rows = scan.linrec_chunk_len(lanes, T), scan.RECURRENCE_ROWS
    else:
        ref = (scan.ballistics_cuda if name == "k8"
               else scan.compressor_fused_cuda)(*args)
        want, rows = scan.detector_chunk_len(lanes, T), scan.DETECTOR_ROWS
    print(f"{name.upper()} headline lanes {lanes}, T {T}: the wrapper's "
          f"chunk {want}", flush=True)
    stages = STAGES[name]
    for L in CHUNKS:
        out = torch.empty_like(ref)
        table = torch.empty((-(-T // L), rows, lanes), device=x.device)
        ms = cs.cuda_ms(lambda: scan_launch(name, args, L, -1, out, table),
                        reps)
        diff = float((out - ref).abs().max())
        parts = cs.stages_ms(
            lambda s: scan_launch(name, args, L, s, out, table),
            len(stages), reps)
        times = ", ".join(f"{n} {p!r}" for n, p in zip(stages, parts))
        print(f"{name.upper()} chunk {L} ({-(-T // L)} chunks): {ms!r} ms; "
              f"{times} ms; max |out - wrapper's| {diff!r}", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernels", default="k1,k6,k7,k8,k11",
                        help="comma-separated subset of k1,k6,k7,k8,k11")
    parser.add_argument("--parent", help="a checkout whose K1 this one's "
                        "must equal bit for bit")
    args = parser.parse_args()
    kernels = args.kernels.split(",")
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    if "k6" in kernels:
        sweep_scan("k6", cs.k6_inputs(cs.POP, 2, cs.T_HEAD, 42, True, dev))
    if "k8" in kernels:
        sweep_scan("k8", cs.k8_inputs(cs.POP, cs.T_HEAD, 44, dev))
    if "k7" in kernels:
        sweep_scan("k7", cs.k7_inputs(cs.POP, 2, cs.T_HEAD, 48, True, dev))
    if "k11" in kernels:
        sweep_scan("k11", cs.k11_inputs(2 * cs.POP, cs.T_HEAD, 49, dev))
    if "k1" in kernels:
        sweep_k1()
    if args.parent and not k1_against_parent(args.parent):
        sys.exit(1)


if __name__ == "__main__":
    main()
