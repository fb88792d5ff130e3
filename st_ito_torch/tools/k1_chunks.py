"""Time K1 (``csrc/eqcomp.cu``) at the headline (1024 lanes x 262144, the
shared input of ``chip_smoke.py``'s ``k1`` phase) at several chunk lengths,
and hold it against float32 and float64 runs of the plain version, lane
by lane, listing the lanes farthest from rule (a) of
``eqcomp.gate_excess``.

    python3 -m st_ito_torch.tools.k1_chunks

The wrapper picks the chunk (``eqcomp.chunk_len``); here the library is
called directly with each length. The plain runs take minutes (a Python
loop over T). Needs a card.
"""

import ctypes
import time

import torch

import chip_smoke as cs
from st_ito_torch.ops.kernels import _build, eqcomp

CHUNKS = (1024, 512, 2048, 256)


def launch(args, L):
    x, vec, S, with_dist, shared = args
    lanes, T = vec.shape[1], x.shape[-1]
    out = torch.empty((lanes, T), device=x.device)
    table = torch.empty((-(-T // L), 2 * S + 4, lanes), device=x.device)
    fn = _build.load("eqcomp").eqcomp_launch
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


def main() -> None:
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    args = cs.k1_inputs(cs.POP, 2, cs.T_HEAD, 2, True, dev)
    vec, S, with_dist = args[1], args[2], args[3]
    for L in CHUNKS:
        ms = cs.cuda_ms(lambda: launch(args, L), 3)
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


if __name__ == "__main__":
    main()
