"""Time variants of K10 (``csrc/fused_fft.cu``) at the fused path's headline
in one run, beside ``torch.fft`` and, optionally, another build of the
kernel with the entry point of the two-pass design (a source given by
``--parent``, e.g. from ``git archive`` of an earlier commit).

    python3 -m st_ito_torch.tools.k10_sweep [--parent DIR]

Each variant is a copy of ``fused_fft.cu`` and the headers beside it
under ``build/k10_sweep/NAME/`` with other constants: the butterfly layers
a step in both directions (``kMaxLayers``; the larger steps are compiled
out), the lag between a chunk's two passes and the depth of the scratch
ring (``fft_persist.cuh``, which K5 and K3 share), and plain loads of the
input in place of the streaming hint. All are built at once
by nvcc with the port's flags; each is checked against ``torch.fft`` and
timed forward (B 512, in_len 2^18 -> 2^19 bins) and inverse (2^19 ->
out_len 2^18), 5 launches after a warm-up, with CUDA events. Needs a card.
"""

import argparse
import ctypes
import subprocess
from pathlib import Path

import torch

import chip_smoke as cs
from st_ito_torch.ops.kernels import _build
from st_ito_torch.ops.kernels import fused_fft as ff
from st_ito_torch.ops.kernels.mega_fft import _radix, _scratch, _twiddles

# (layers a step at most, lag, ring slots, streaming input loads)
VARIANTS = ((5, 3, 7, 1), (4, 3, 7, 1), (4, 3, 9, 1), (4, 4, 9, 1),
            (4, 4, 11, 1), (4, 3, 7, 0), (5, 4, 9, 1), (4, 5, 12, 1),
            (3, 4, 9, 1))
N, B, T = 2 ** 19, 512, 2 ** 18


def write_variants(out: Path) -> dict:
    variants = {}
    for cap, lag, ring, streaming in VARIANTS:
        name = f"cap{cap}_lag{lag}_ring{ring}_cs{streaming}"
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for header in _build.CSRC.glob("*.cuh"):
            text = header.read_text()
            if header.name == "fft_persist.cuh":
                text = text.replace("constexpr int kLag = 3;",
                                    f"constexpr int kLag = {lag};")
                text = text.replace("constexpr int kRing = 9;",
                                    f"constexpr int kRing = {ring};")
                if not streaming:
                    text = text.replace(
                        "make_float2(__ldcs(zr + t), __ldcs(zi + t))",
                        "make_float2(zr[t], zi[t])")
            (d / header.name).write_text(text)
        s = (_build.CSRC / "fused_fft.cu").read_text().replace(
            "constexpr int kMaxLayers = kInverse ? 4 : 5;",
            f"constexpr int kMaxLayers = {cap};")
        (d / "fused_fft.cu").write_text(s)
        variants[name] = d / "fused_fft.cu"
    return variants


def build(sources: dict, out: Path) -> None:
    procs = {name: subprocess.Popen(
        [_build._nvcc()] + _build._ARCH + _build._COMMON
        + ["-fmad=false", "-o", str(out / f"lib{name}.so"), str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, path in sources.items()}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        regs = [line.split(":")[-1].strip() for line in log.splitlines()
                if "registers" in line or "spill" in line]
        print(name, "nvcc", proc.returncode, " | ".join(regs), flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", help="a checkout whose "
                        "st_ito_torch/csrc/fused_fft.cu has the two-pass "
                        "entry point (with a chunk argument)")
    args = parser.parse_args()
    out = _build.BUILD_DIR.parent / "k10_sweep"
    out.mkdir(parents=True, exist_ok=True)
    sources = write_variants(out)
    if args.parent:
        sources["parent"] = (Path(args.parent) / "st_ito_torch" / "csrc"
                             / "fused_fft.cu")
    build(sources, out)

    dev = torch.device("cuda")
    n1, n2 = _radix(N)
    g = torch.Generator(device=dev).manual_seed(60)
    cases = {"fwd": ([torch.randn((B, T), generator=g, device=dev)
                      for _ in range(2)], -1, T, N),
             "inv": ([torch.randn((B, N), generator=g, device=dev)
                      for _ in range(2)], 1, N, T)}
    want = {d: ff.fft_fused_plain(*z, sign=s, n=N, out_len=ol)
            for d, (z, s, il, ol) in cases.items()}
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run_variant(lib, z, sign, in_len, out_len):
        fn = lib.fft_fused_launch
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                       + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        slots = lib.fft_fused_scratch_slots()
        yr = torch.empty((B, out_len), device=dev)
        yi = torch.empty_like(yr)
        cnt = torch.empty(1 + 2 * B, dtype=torch.int32, device=dev)
        err = fn(z[0].data_ptr(), z[1].data_ptr(), in_len, yr.data_ptr(),
                 yi.data_ptr(), _scratch(N, slots, dev).data_ptr(),
                 _twiddles(n1, dev).data_ptr(), ff._roots(N, dev).data_ptr(),
                 cnt.data_ptr(), B, in_len, n1, n2, out_len, sign, stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return yr, yi

    def run_parent(lib, z, sign, in_len, out_len, chunk=64):
        fn = lib.fft_fused_launch
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                       + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        yr = torch.empty((B, out_len), device=dev)
        yi = torch.empty_like(yr)
        err = fn(z[0].data_ptr(), z[1].data_ptr(), in_len, yr.data_ptr(),
                 yi.data_ptr(), _scratch(N, chunk, dev).data_ptr(),
                 _twiddles(n1, dev).data_ptr(), B, in_len, n1, n2, out_len,
                 chunk, sign, stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return yr, yi

    def time_all(label, f):
        for d, (z, s, il, ol) in cases.items():
            _, rel = cs.rel_err(f(z, s, il, ol), want[d])
            ms = cs.cuda_ms(lambda: f(z, s, il, ol), 5)
            print(f"{label} {d}: {ms!r} ms, relative error {rel:.3g}",
                  flush=True)

    def library():
        for d, (z, s, il, ol) in cases.items():
            ms = cs.cuda_ms(lambda: ff.fft_fused_plain(*z, sign=s, n=N,
                                                       out_len=ol), 3)
            print(f"torch.fft {d}: {ms!r} ms", flush=True)

    print(cs.card_line(), flush=True)
    library()
    for name in sources:
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        run = run_parent if name == "parent" else run_variant
        time_all(name, lambda z, s, il, ol, lib=lib, run=run:
                 run(lib, z, s, il, ol))
        torch.cuda.empty_cache()
    library()


if __name__ == "__main__":
    main()
