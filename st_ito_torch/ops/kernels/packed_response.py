"""K9 and K2: fused LTI response construction + packed hermitian apply.

Port of ``st_ito_tpu/ops/pallas/packed_response.py:133
packed_response_apply_rp`` (K9, flat (B, F) rows), ``:267
packed_response_apply_rp_padded`` (K2, the pitched (B, Rp, n1) half grid of
the FFT kernels) and the stage-input assembly of ``:188
_build_stage_inputs``. Both are one CUDA kernel,
``st_ito_torch/csrc/packed_response.cu``, with two launch entries; beside
them here are their plain PyTorch versions, the rp math of
``chain/rp_responses.py`` vectorised over the full (B, F) grid. The
wrappers ``packed_response_apply`` and ``packed_response_apply_rp_padded``
run the plain version for CPU tensors and the kernel for any other: on a
CUDA tensor they launch the kernel or raise.

A stage is ``(effect, params, active)``: ``effect`` one of ``RP_BUNDLES``,
``params`` a dict name -> (B,) tensor of denormalized values, ``active`` a
(B,) bypass mask (1 = effect on) or None. ``tables`` maps each effect to
its frequency tables at the full F (``rp_tables``, which builds them once
per (sample rate, n, device) and keeps them).
"""

from __future__ import annotations

import ctypes
import math

import torch

from st_ito_torch.ops.kernels import _build

# Kernel launches since the last reset (chip_smoke.py and
# portbench/core/counters.py read them): K9's flat form and K2's pitched
# form.
launches = 0
launches_padded = 0

# the kernel's stage codes and per-stage parameter order
STAGE_CODES = {"delay": 0, "gain": 1, "stereo_widener": 2, "reverb": 3}
STAGE_PARAMS = {
    "delay": ("delay_seconds", "feedback", "mix"),
    "gain": ("gain_db",),
    "stereo_widener": ("width",),
    "reverb": ("room_size", "damping", "wet_dry", "width"),
}
_MAX_STAGES = 8
_PARAMS_PER_STAGE = 4


def _rp():
    """chain/rp_responses, imported at first use: the chain package imports
    the renderer, which imports this module."""
    from st_ito_torch.chain import rp_responses

    return rp_responses


# (effects, sample rate, n, device) -> tables. They are read-only, so every
# renderer and call shares one copy (the Freeverb rows are 40 MB at n = 2^19).
_TABLES: dict = {}


def rp_tables(effects, sample_rate: float, n: int, device) -> dict:
    """effect -> its rp frequency tables on the (n/2 + 1)-bin half grid,
    built on the first request for (effects, sample rate, n, device)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (tuple(sorted(set(effects))), float(sample_rate), int(n), device)
    if key not in _TABLES:
        rp = _rp()
        F = n // 2 + 1
        _TABLES[key] = {e: rp.RP_BUNDLES[e][0](sample_rate, n, F, device)
                        for e in key[0]}
    return _TABLES[key]


def _masks(stages):
    """Per-stage (B,) masks, or None when no stage is ever bypassed: as in
    the JAX package, once any stage has a mask every stage gets one."""
    if all(active is None for _, _, active in stages):
        return [None] * len(stages)
    out = []
    for _, params, active in stages:
        ref = next(iter(params.values()))
        out.append(torch.ones_like(ref, dtype=torch.float32) if active is None
                   else active.to(torch.float32))
    return out


def packed_response_plain(ZrL, ZiL, ZrR, ZiR, stages, tables):
    """Plain PyTorch version: evaluate, bypass-blend and compose every
    stage's response on the full (B, F) grid, apply the packed formula and
    the DC/Nyquist correction. Returns (YloR, YloI, YhigR, YhigI)."""
    rp = _rp()
    kind, H = "scalar", None
    for (effect, params, _), active in zip(stages, _masks(stages)):
        build = rp.RP_BUNDLES[effect][1]
        p = {k: v.to(torch.float32).reshape(-1, 1) for k, v in params.items()}
        k2, H2 = build(p, tables[effect])
        if active is not None:
            k2, H2 = rp.rp_bypass(k2, H2, active.reshape(-1, 1))
        kind, H = rp.rp_compose(kind, H, k2, H2)
    P, Q, Pc, Qc = rp.rp_packed_coeffs(kind, H)
    ylo_r, ylo_i, yhi_r, yhi_i = rp.rp_packed_apply(P, Q, Pc, Qc, ZrL, ZiL,
                                                    ZrR, ZiR)
    F = ZrL.shape[-1]
    idx = torch.arange(F, device=ZrL.device)[None, :]
    sel = (idx == 0) | (idx == F - 1)
    ylo_r = torch.where(sel, 0.5 * (ylo_r + yhi_r), ylo_r)
    ylo_i = torch.where(sel, 0.5 * (ylo_i + yhi_i), ylo_i)
    return ylo_r, ylo_i, yhi_r, yhi_i


def stage_args(stages, B: int, F: int, tables, dev):
    """What the kernels take for a stage list: (codes, n_stages, params
    (n_stages, 4, B), active (n_stages, B) or None, Freeverb table (38, F)
    or None, sample rate). Raises on a stage list they do not take. K9, K2
    and K3 (``ops/kernels/mega_fft.py``) all pass these on."""
    if not 1 <= len(stages) <= _MAX_STAGES:
        raise ValueError(f"{len(stages)} stages; the kernel takes 1 to "
                         f"{_MAX_STAGES}")
    codes = 0
    prm = torch.zeros((len(stages), _PARAMS_PER_STAGE, B), dtype=torch.float32,
                      device=dev)
    for s, (effect, params, _) in enumerate(stages):
        if effect not in STAGE_CODES:
            raise ValueError(f"the packed_response kernel has no stage "
                             f"{effect!r}; it takes {sorted(STAGE_CODES)}")
        codes |= STAGE_CODES[effect] << (4 * s)
        for j, name in enumerate(STAGE_PARAMS[effect]):
            prm[s, j] = params[name].to(device=dev, dtype=torch.float32)
    masks = _masks(stages)
    act = (None if masks[0] is None
           else torch.stack(masks).to(device=dev).contiguous())
    table = (tables["reverb"]["_packed"]
             if any(e == "reverb" for e, _, _ in stages) else None)
    if table is not None and (table.device != dev or table.shape[1] != F
                              or not table.is_contiguous()):
        raise ValueError("the reverb table must be a contiguous (38, F) "
                         "tensor on the spectra's device")
    sr = tables["delay"]["_sr"] if "delay" in tables else 0.0
    return codes, len(stages), prm, act, table, sr


def data_ptr(t):
    """A tensor's device address for ctypes, None (a null pointer) for None."""
    return None if t is None else t.data_ptr()


def _launch(entry: str, Z, shape, stages, tables, F: int, pitch,
            stage: int = -1):
    """Check the four spectra, allocate the outputs and launch ``entry``;
    ``pitch`` is None for K9's flat rows, Fp for K2's. ``stage`` >= 0
    launches one of the kernel's timing probes instead
    (``tools/k4_stages.py``): 0 the loads and stores alone (Y = Z), 1 the
    response with IEEE division, 2 with the approximate one."""
    lib = _build.load("packed_response")
    B = shape[0]
    n = 2 * (F - 1)
    dev = Z[0].device
    if dev.type != "cuda":
        raise ValueError(f"packed_response kernel needs CUDA tensors, got {dev}")
    for z in Z:
        if (z.device != dev or z.dtype != torch.float32
                or not z.is_contiguous() or tuple(z.shape) != tuple(shape)):
            raise ValueError("packed_response kernel takes four contiguous "
                             f"float32 {tuple(shape)} tensors on one CUDA "
                             "device")
    codes, n_stages, prm, act, table, sr = stage_args(stages, B, F, tables,
                                                      dev)
    outs = [torch.empty(shape, dtype=torch.float32, device=dev)
            for _ in range(4)]
    fn = getattr(lib, entry)
    fn.argtypes = ([ctypes.c_void_p] * 8
                   + [ctypes.c_uint, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p]
                   + [ctypes.c_int] * (3 if pitch is None else 4)
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    dims = (B, F, n) if pitch is None else (B, F, pitch, n)
    err = fn(*(z.data_ptr() for z in Z), *(o.data_ptr() for o in outs),
             codes, n_stages, prm.data_ptr(), data_ptr(act), data_ptr(table), *dims,
             2.0 * math.pi / n, sr, stage,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {err}")
    return tuple(outs)


def packed_response_cuda(ZrL, ZiL, ZrR, ZiR, stages, tables,
                         stage: int = -1):
    """Launch K9 on the current stream (``stage``: ``_launch``)."""
    global launches
    B, F = ZrL.shape
    outs = _launch("packed_response_launch", (ZrL, ZiL, ZrR, ZiR), (B, F),
                   stages, tables, F, None, stage)
    launches += 1
    return outs


def packed_response_apply(ZrL, ZiL, ZrR, ZiR, stages, tables):
    """Run the fused response + packed apply on the half-grid spectra.

    ZrL/ZiL: Z on k in [0, n/2], (B, F) float32. ZrR/ZiR: Zrev[k] =
    Z[(n-k) mod n] on the same range. Returns (YloR, YloI, YhigR, YhigI),
    each (B, F): Ylo[k] = Y[k] (DC/Nyquist-corrected) and Yhig[k] =
    Y[(n-k) mod n]."""
    if ZrL.device.type == "cpu":
        return packed_response_plain(ZrL, ZiL, ZrR, ZiR, stages, tables)
    return packed_response_cuda(ZrL, ZiL, ZrR, ZiR, stages, tables)


# ------------------------------------------------------------------- K2


def packed_response_padded_plain(ZrL, ZiL, ZrR, ZiR, stages, tables, n: int):
    """Plain PyTorch version of K2: ``packed_response_plain`` on the F valid
    bins of each pitched row; the bins past F come back as zeros."""
    shape = ZrL.shape
    B, F = shape[0], n // 2 + 1
    valid = packed_response_plain(
        *(z.reshape(B, -1)[:, :F] for z in (ZrL, ZiL, ZrR, ZiR)), stages,
        tables)
    outs = []
    for v in valid:
        o = torch.zeros((B, shape[1] * shape[2]), dtype=v.dtype,
                        device=v.device)
        o[:, :F] = v
        outs.append(o.reshape(shape))
    return tuple(outs)


def packed_response_padded_cuda(ZrL, ZiL, ZrR, ZiR, stages, tables, n: int,
                                stage: int = -1):
    """Launch K2 on the current stream (``stage``: ``_launch``). The bins
    past F of the outputs are left as allocated."""
    global launches_padded
    B, Rp, n1 = ZrL.shape
    outs = _launch("packed_response_padded_launch", (ZrL, ZiL, ZrR, ZiR),
                   (B, Rp, n1), stages, tables, n // 2 + 1, Rp * n1, stage)
    launches_padded += 1
    return outs


def packed_response_apply_rp_padded(ZrL, ZiL, ZrR, ZiR, stages, tables,
                                    n: int):
    """K2: ``packed_response_apply`` on the pitched half grid of the FFT
    kernels (``ops/kernels/mega_fft.py``). The four spectra are
    (B, Rp, n1) float32, a row of pitch Fp = Rp*n1 per candidate with bin k
    at flat index k; the F = n/2 + 1 bins k <= n/2 are read and written
    (the Nyquist bin at flat index F - 1), the rest is junk in and out.
    Port of ``st_ito_tpu/ops/pallas/packed_response.py:267``; the JAX
    kernel's candidate and row block rules (B % 8, Rp % 8) are TPU tile
    rules and are not kept."""
    if ZrL.ndim != 3 or ZrL.shape[1] * ZrL.shape[2] < n // 2 + 1:
        raise ValueError(f"K2 takes (B, Rp, n1) spectra with Rp*n1 >= n/2 + 1 "
                         f"for n = {n}, got {tuple(ZrL.shape)}")
    if ZrL.device.type == "cpu":
        return packed_response_padded_plain(ZrL, ZiL, ZrR, ZiR, stages,
                                            tables, n)
    return packed_response_padded_cuda(ZrL, ZiL, ZrR, ZiR, stages, tables, n)

