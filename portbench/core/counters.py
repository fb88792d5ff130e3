"""The program's kernel launch counters (``launches`` in each kernel
wrapper module of ``st_ito_torch.ops.kernels``), by the kernel names of
PERF.md's table. The wrappers count a launch of the CUDA kernel only."""

from __future__ import annotations


def _modules():
    from st_ito_torch.ops.kernels import (eqcomp, fused_fft, mega_fft,
                                          packed_response, scan)

    return eqcomp, fused_fft, mega_fft, packed_response, scan


def read() -> dict[str, int]:
    eqcomp, fused_fft, mega_fft, k9, scan = _modules()
    return {"k1": eqcomp.launches, "k9": k9.launches,
            "k2": k9.launches_padded,
            "k5": mega_fft.launches["fwd_pack_fft"],
            "k3": mega_fft.launches["fwd_pack_fft_response"],
            "k4": mega_fft.launches["inv_unpack_fft"],
            "k6": scan.launches["biquad_cascade"],
            "k7": scan.launches["compressor_fused"],
            "k8": scan.launches["ballistics"],
            "k10": fused_fft.launches,
            "k11": scan.launches["linear_recurrence"]}


def reset() -> None:
    eqcomp, fused_fft, mega_fft, k9, scan = _modules()
    eqcomp.launches = k9.launches = k9.launches_padded = 0
    fused_fft.launches = 0
    for counts in (mega_fft.launches, scan.launches):
        for name in counts:
            counts[name] = 0
