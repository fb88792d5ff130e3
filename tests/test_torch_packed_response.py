"""K9, the fused LTI response + packed hermitian apply: the port's plain
PyTorch version against st_ito_tpu's packed_response_apply_rp (interpret
mode) and its pure-jnp reference; a torch model of the kernel's arithmetic
(each stage's candidate terms once, then the per-bin math), bitwise the
plain version's under IEEE division and within K9's tolerance with every
division off by 2 ulp (the approximate divide's bound); and (on a card
only) the CUDA kernels K9 and K2 against the plain version, also on the
delay's comb resonances."""

import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from st_ito_tpu.ops.pallas.packed_response import (
    _build_stage_inputs,
    packed_response_apply_rp,
    packed_response_apply_rp_reference,
)

import chip_smoke as cs
from st_ito_torch.chain import rp_responses as rp
from st_ito_torch.ops.kernels import mega_fft as mf
from st_ito_torch.ops.kernels import packed_response as k9
from tests.torch_jax_cache import shared_compile_cache  # noqa: F401

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)

SR = 48000


def _case(B, n, seed, with_masks=True):
    """Seeded half-grid spectra and delay + reverb stages with a fractional
    delay (complex DC/Nyquist responses) and mixed bypass masks."""
    rng = np.random.default_rng(seed)
    F = n // 2 + 1
    Z = [rng.standard_normal((B, F)).astype(np.float32) for _ in range(4)]
    delay = {"delay_seconds": rng.uniform(0.01, 1.0, B) + 0.37 / SR,
             "feedback": rng.uniform(0.05, 1.0, B),
             "mix": rng.uniform(0.0, 1.0, B)}
    reverb = {k: rng.uniform(0.0, 1.0, B)
              for k in ("room_size", "damping", "wet_dry", "width")}
    stages = []
    for effect, p in (("delay", delay), ("reverb", reverb)):
        m = None
        if with_masks:
            m = rng.random(B) > 0.4
            m[0] = True
        stages.append((effect, {k: v.astype(np.float32) for k, v in p.items()},
                       m))
    return Z, stages


def _port(Z, stages, n, device="cpu"):
    t_stages = [(e, {k: torch.as_tensor(v, device=device)
                     for k, v in p.items()},
                 None if m is None else torch.as_tensor(m, device=device))
                for e, p, m in stages]
    tables = k9.rp_tables([e for e, _, _ in stages], SR, n, device)
    return k9.packed_response_apply(
        *(torch.as_tensor(z, device=device) for z in Z), t_stages, tables)


def _jax(Z, stages, n, reference):
    F = n // 2 + 1
    Fp = -(-F // 512) * 512
    j_stages = [(e, {k: jnp.asarray(v) for k, v in p.items()},
                 None if m is None else jnp.asarray(m))
                for e, p, m in stages]
    descrs, P, A, T = _build_stage_inputs(j_stages, Z[0].shape[0], n, SR, Fp)
    if reference:
        Zp = [jnp.pad(jnp.asarray(z), ((0, 0), (0, Fp - F))) for z in Z]
        out = packed_response_apply_rp_reference(*Zp, descrs, P, A, T,
                                                 nyq_bin=F - 1)
        return [np.asarray(o)[:, :F] for o in out]
    out = packed_response_apply_rp(*map(jnp.asarray, Z), descrs, P, A, T,
                                   interpret=True)
    return [np.asarray(o) for o in out]


def _assert_rel(got, want, rel):
    scale = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        err = float(np.abs(np.asarray(g) - w).max())
        assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("reference", [False, True],
                         ids=["pallas_interpret", "jnp_reference"])
@pytest.mark.parametrize("with_masks", [True, False])
def test_plain_matches_jax(reference, with_masks):
    n = 2048
    Z, stages = _case(3, n, 5, with_masks)
    got = [o.numpy() for o in _port(Z, stages, n)]
    _assert_rel(got, _jax(Z, stages, n, reference), 1e-4)


def test_dc_nyquist_bins_are_corrected():
    """The fractional delay makes the DC and Nyquist responses complex, so
    the correction changes those bins: the uncorrected JAX reference must
    differ there, and the port must match the corrected one."""
    n = 1024
    Z, stages = _case(3, n, 9)
    got = [o.numpy() for o in _port(Z, stages, n)]
    F = n // 2 + 1
    j_stages = [(e, {k: jnp.asarray(v) for k, v in p.items()},
                 jnp.asarray(m)) for e, p, m in stages]
    descrs, P, A, T = _build_stage_inputs(j_stages, 3, n, SR, F)
    raw = packed_response_apply_rp_reference(*map(jnp.asarray, Z), descrs, P,
                                             A, T)
    for k in (0, F - 1):
        assert np.abs(got[0][:, k] - np.asarray(raw[0])[:, k]).max() > 1e-3
    _assert_rel(got, _jax(Z, stages, n, True), 1e-4)


def _terms(effect, p, t):
    """``csrc/rp_response.cuh stage_terms``: what a stage takes from its
    candidate alone, each a (B, 1) tensor, computed once."""
    if effect == "delay":
        D = p["delay_seconds"] * t["_sr"]
        Di = torch.floor(D)
        return dict(Di=Di, Df=D - Di, fb=p["feedback"] * 0.999, mix=p["mix"])
    if effect == "gain":
        return dict(g=torch.pow(10.0, p["gain_db"] / 20.0))
    if effect == "stereo_widener":
        _, (amb, _, b, _, _, _) = rp.widener_build(p, t)
        return dict(amb=amb, b=b)
    fb = p["room_size"] * 0.28 + 0.7
    d = p["damping"] * 0.4
    return dict(g=fb * (1.0 - d), d=d, wet=p["wet_dry"], width=p["width"])


def _bin_response(effect, tm, t, div):
    """``rp_response.cuh``'s per-bin builds from the Terms ``tm``, every
    division through ``div``."""
    if effect == "delay":
        n = t["_n"]
        m = (t["kidx"] * tm["Di"].to(torch.int64)) & (n - 1)
        th = (2.0 * math.pi / n) * m.to(torch.float32) + t["omega"] * tm["Df"]
        c, s = torch.cos(th), torch.sin(th)
        dr = 1.0 - tm["fb"] * c
        di = tm["fb"] * s
        idd = div(1.0, dr * dr + di * di)
        hwr = (c * dr - s * di) * idd
        hwi = -(c * di + s * dr) * idd
        mix = tm["mix"]
        return "scalar", ((1.0 - mix) + mix * hwr, mix * hwi)
    if effect == "gain":
        return "scalar", (tm["g"], torch.zeros_like(tm["g"]))
    if effect == "stereo_widener":
        z = torch.zeros_like(tm["b"])
        return "monomix", (tm["amb"], z, tm["b"], z, tm["b"], z)
    Ar = 1.0 - tm["d"] * t["cos1"]
    Ai = tm["d"] * t["sin1"]
    q = div(tm["g"], Ar * Ar + Ai * Ai)
    gAr, gAi = q * Ar, -q * Ai
    H = {}
    for ch in ("L", "R"):
        sr_ = si_ = None
        for j in range(8):
            wr = t[f"comb{ch}_c"][j][None, :] - gAr
            wi = t[f"comb{ch}_s"][j][None, :] - gAi
            idd = div(1.0, wr * wr + wi * wi)
            r, i = wr * idd, -wi * idd
            sr_ = r if sr_ is None else sr_ + r
            si_ = i if si_ is None else si_ + i
        H[ch] = rp.cmul(sr_, si_, t[f"ap{ch}_r"], t[f"ap{ch}_i"])
    (HLr, HLi), (HRr, HRi) = H["L"], H["R"]
    wet, width = tm["wet"], tm["width"]
    gain_in = 0.015
    w1 = 0.5 * wet * 3.0 * (1.0 + width) * gain_in
    w2 = 0.5 * wet * 3.0 * (1.0 - width) * gain_in
    dry = (1.0 - wet) * 2.0
    return "monomix", (dry, torch.zeros_like(dry),
                       w1 * HLr + w2 * HRr, w1 * HLi + w2 * HRi,
                       w1 * HRr + w2 * HLr, w1 * HRi + w2 * HLi)


def hoisted_model(Z, stages, tables, div=lambda a, b: a / b):
    """The arithmetic of K9 and K2 (``csrc/packed_response.cu``) in torch:
    each stage's Terms once per candidate, then per bin the stage's
    response from them, the bypass blend, the composition, the packed
    coefficients and apply, the DC/Nyquist correction."""
    kind, H = "scalar", None
    for (effect, params, _), active in zip(stages, k9._masks(stages)):
        p = {k: v.to(torch.float32).reshape(-1, 1) for k, v in params.items()}
        k2, H2 = _bin_response(effect, _terms(effect, p, tables[effect]),
                               tables[effect], div)
        if active is not None:
            k2, H2 = rp.rp_bypass(k2, H2, active.reshape(-1, 1))
        kind, H = rp.rp_compose(kind, H, k2, H2)
    ylo_r, ylo_i, yhi_r, yhi_i = rp.rp_packed_apply(
        *rp.rp_packed_coeffs(kind, H), *Z)
    F = Z[0].shape[-1]
    idx = torch.arange(F)[None, :]
    sel = (idx == 0) | (idx == F - 1)
    return (torch.where(sel, 0.5 * (ylo_r + yhi_r), ylo_r),
            torch.where(sel, 0.5 * (ylo_i + yhi_i), ylo_i), yhi_r, yhi_i)


def ulp_div(seed, ulps=2):
    """a / b moved ``ulps`` float32 steps up or down (a random sign per
    element): the bound of the kernels' approximate divide
    (``__fdividef``, ``rp_response.cuh FastMath``)."""
    g = torch.Generator().manual_seed(seed)

    def div(a, b):
        q = a / b
        up = torch.rand(q.shape, generator=g) < 0.5
        to = torch.where(up, math.inf, -math.inf).to(q.dtype)
        for _ in range(ulps):
            q = torch.nextafter(q, to)
        return q
    return div


def _spectra(B, n, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, n // 2 + 1)).astype(
        np.float32)) for _ in range(4)]


def _stage_sets(n):
    """(label, stages) of the model tests at n: random delay + reverb with
    and without masks, a gain and a widener stage, and the delay's comb
    resonances (``chip_smoke.resonant_stage_case``)."""
    out = []
    for masks in (True, False):
        _, st = _case(16, n, 21, masks)
        out.append((f"delay+reverb, masks {masks}", [
            (e, {k: torch.as_tensor(v) for k, v in p.items()},
             None if m is None else torch.as_tensor(m)) for e, p, m in st]))
    rng = np.random.default_rng(22)
    out.append(("gain+widener+delay", [
        ("gain", {"gain_db": torch.from_numpy(
            rng.uniform(-24, 24, 16).astype(np.float32))}, None),
        ("stereo_widener", {"width": torch.from_numpy(
            rng.uniform(0, 1, 16).astype(np.float32))},
         torch.from_numpy(rng.random(16) > 0.5)),
        out[0][1][0]]))
    out.append(("comb resonances",
                cs.resonant_stage_case(16, np.random.default_rng(23), "cpu")))
    return out


@pytest.mark.parametrize("n", [2 ** 14])
def test_hoisted_model_equals_plain_bitwise(n):
    """Computing each candidate's terms once changes nothing: under IEEE
    division the model equals the plain version bit for bit."""
    Z = _spectra(16, n, 20)
    for label, stages in _stage_sets(n):
        tables = k9.rp_tables([e for e, _, _ in stages], SR, n, "cpu")
        want = k9.packed_response_plain(*Z, stages, tables)
        got = hoisted_model(Z, stages, tables)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), label


@pytest.mark.parametrize("n", [2 ** 14])
def test_approximate_division_holds_the_tolerance(n):
    """Every division 2 ulp off (the approximate divide's bound) keeps the
    response within 1e-4 x max|want| of the plain version (IEEE), on the
    random stage sets and on the delay's comb resonances, where the
    response reaches about 1e3 (measured 2.0e-7 to 3.9e-6)."""
    Z = _spectra(16, n, 24)
    for i, (label, stages) in enumerate(_stage_sets(n)):
        tables = k9.rp_tables([e for e, _, _ in stages], SR, n, "cpu")
        want = k9.packed_response_plain(*Z, stages, tables)
        got = hoisted_model(Z, stages, tables, div=ulp_div(i))
        _assert_rel([g.numpy() for g in got], [w.numpy() for w in want],
                    1e-4)


def test_approximate_division_matches_jax():
    """The model with 2-ulp divisions against the JAX kernel (interpret
    mode): within 1e-4 x max|want|, K9's tolerance."""
    n = 2048
    Z, stages = _case(3, n, 5, True)
    t_stages = [(e, {k: torch.as_tensor(v) for k, v in p.items()},
                 torch.as_tensor(m)) for e, p, m in stages]
    tables = k9.rp_tables(["delay", "reverb"], SR, n, "cpu")
    got = hoisted_model([torch.from_numpy(z) for z in Z], t_stages, tables,
                        div=ulp_div(7))
    _assert_rel([g.numpy() for g in got], _jax(Z, stages, n, False), 1e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device):
    # 70 candidates: two 64-candidate chunks per frequency tile, one ragged
    n = 2 ** 16
    Z, stages = _case(70, n, 13)
    want = [o.numpy() for o in _port(Z, stages, n)]
    before = k9.launches
    got = _port(Z, stages, n, cuda_device)
    torch.cuda.synchronize()
    assert k9.launches == before + 1
    _assert_rel([g.cpu().numpy() for g in got], want, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n,B", [(2 ** 14, 37), (2 ** 19, 64)])
def test_kernels_hold_on_comb_resonances_on_card(cuda_device, n, B):
    """K9 (flat rows) and K2 (the pitched half grid) at the delay's
    resonances, where the approximate divide's error is magnified most:
    within 1e-4 x max|want| of the plain version."""
    stages = cs.resonant_stage_case(B, np.random.default_rng(25),
                                    cuda_device)
    tables = k9.rp_tables(["delay", "reverb"], SR, n, cuda_device)
    Z = [z.to(cuda_device) for z in _spectra(B, n, 26)]
    want = k9.packed_response_plain(*Z, stages, tables)
    got = k9.packed_response_cuda(*Z, stages, tables)
    torch.cuda.synchronize()
    _assert_rel([g.cpu().numpy() for g in got],
                [w.cpu().numpy() for w in want], 1e-4)
    Rp, n1 = mf.half_grid(n)
    Zp = [torch.zeros((B, Rp * n1), device=cuda_device) for _ in Z]
    for zp, z in zip(Zp, Z):
        zp[:, :n // 2 + 1] = z
    got = k9.packed_response_padded_cuda(
        *(zp.reshape(B, Rp, n1) for zp in Zp), stages, tables, n)
    torch.cuda.synchronize()
    _assert_rel([g.reshape(B, -1)[:, :n // 2 + 1].cpu().numpy() for g in got],
                [w.cpu().numpy() for w in want], 1e-4)
