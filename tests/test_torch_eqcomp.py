"""K1, the fused EQ -> compressor (-> distortion) scan: the port's plain
PyTorch version against st_ito_tpu's eq_compressor_fused_pallas run in
interpret mode; a torch model of the CUDA kernel's chunked scan (passes A-D
and their three carries, ``csrc/eqcomp.cu``) against the plain version; and
(on a card only) the CUDA kernel against the plain version.

The chunk carries round differently from the serial chain, and tanh
multiplies a rounding of y by up to drive x output gain (about 4000 at the
distortion's +48 dB drive and +24 dB output gain), so the kernel is held to
two rules (``eqcomp.gate_excess``): (a) where a lane's distortion is
bypassed, within 1e-4 of the float32 plain run times the lane's peak (at
least 1); (b) on every lane, no farther from a float64 run of the plain
version than 4x the float32 plain run is, plus 1e-5 x the lane's peak. The
float32 plain run itself lies up to 2.4e-5 x peak from the float64 one on
lanes whose distortion is bypassed (the cascade's low, high-gain sections),
so two float32 orders of rounding may differ by about twice that; the model
below reads up to 3.1e-5 x peak from it there."""

import functools
import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from st_ito_tpu.ops.pallas.scan import eq_compressor_fused_pallas

from st_ito_torch.chain import basic_chain
from st_ito_torch.chain.executor import stage_params
from st_ito_torch.chain.responses import _eq_section_stack
from st_ito_torch.ops.dynamics import _time_constant_alpha
from st_ito_torch.ops.kernels import eqcomp

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)

SR = 48000


def _inputs(B, C, T, seed, shared, with_dist, with_masks):
    """Seeded inputs for both implementations: per-candidate or shared x,
    the basic EQ's 6 sections and compressor/distortion scalars as
    (B, 1) columns, and bypass masks mixing on and off."""
    rng = np.random.default_rng(seed)
    chain = basic_chain()
    (eq, eq_s, _), (comp, c_s, _), (dist, d_s, _) = chain.stage_slices()[:3]
    W = torch.from_numpy(rng.random((B, chain.num_params)).astype(np.float32))
    p_eq = stage_params(eq, W, eq_s, 1)
    p_c = stage_params(comp, W, c_s, 1)
    p_d = stage_params(dist, W, d_s, 1)
    b, a = _eq_section_stack(p_eq, SR)
    x = rng.standard_normal((C, T) if shared else (B, C, T)).astype(
        np.float32) * 0.5

    def col(v):
        return np.asarray(v, np.float32)[:, None]

    def mask():
        m = (rng.random(B) > 0.5).astype(np.float32)
        m[0], m[-1] = 1.0, 0.0
        return col(m)

    kw = dict(
        threshold_db=col(p_c["threshold_db"]), ratio=col(p_c["ratio"]),
        knee_db=0.5,
        alpha_attack=col(_time_constant_alpha(p_c["attack_ms"], SR)),
        alpha_release=col(_time_constant_alpha(p_c["release_ms"], SR)),
        makeup_gain_db=0.0)
    if with_masks:
        kw.update(eq_active=mask(), comp_active=mask())
    if with_dist:
        kw.update(drive_db=col(p_d["drive_db"]),
                  dist_gain_db=col(p_d["output_gain_db"]))
        if with_masks:
            kw["dist_active"] = mask()
    shared_lead = (B, C) if shared else None
    return x, b[:, None].numpy(), a[:, None].numpy(), kw, shared_lead


def _port(x, b, a, kw, shared_lead, device="cpu"):
    def t(v):
        return (torch.as_tensor(v, device=device)
                if isinstance(v, np.ndarray) else v)

    return eqcomp.eq_compressor_fused(
        t(x), t(b), t(a), shared_lead_shape=shared_lead,
        **{k: t(v) for k, v in kw.items()})


@pytest.mark.parametrize("shared,with_dist,with_masks", [
    (True, True, True),     # the basic chain's head on the shared input
    (False, True, True),    # per-candidate input
    (False, False, True),   # the 2-stage EQ -> compressor form
    (True, False, False),   # no bypass slots
])
def test_plain_matches_pallas_interpret(shared, with_dist, with_masks):
    B, C, T = 3, 2, 3000
    x, b, a, kw, shared_lead = _inputs(B, C, T, 7, shared, with_dist,
                                       with_masks)
    got = _port(x, b, a, kw, shared_lead).numpy()
    want = np.asarray(eq_compressor_fused_pallas(
        jnp.asarray(x), jnp.asarray(b), jnp.asarray(a),
        shared_lead_shape=shared_lead, t_block=512, interpret=True,
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}))
    assert got.shape == want.shape == (B, C, T)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_launch_count_is_zero_on_cpu():
    x, b, a, kw, shared_lead = _inputs(2, 2, 64, 1, True, True, True)
    before = eqcomp.launches
    _port(x, b, a, kw, shared_lead)
    assert eqcomp.launches == before


def _cascade(co, st, v):
    """The TDF-II cascade step of the kernel and the plain version; st is
    a list of [s1, s2] per section, updated in place. Returns v."""
    for s, (b0, b1, b2, a1, a2) in enumerate(co):
        s1, s2 = st[s]
        y = b0 * v + s1
        st[s] = [b1 * v - a1 * y + s2, b2 * v - a2 * y]
        v = y
    return v


def _computer(v, th, slope, knee):
    env_db = torch.log(torch.clamp_min(v.abs(), 1e-8)) * eqcomp._DB_PER_LOG
    over = env_db - th
    h = over + knee / 2.0
    knee_region = slope * (h * h) / (2.0 * knee)
    return torch.where(2.0 * over < -knee, torch.zeros_like(over),
                       torch.where(2.0 * over > knee, slope * over,
                                   knee_region))


def _chunked_model(x_in, vec, S, with_dist, shared_channels, Lc):
    """The CUDA kernel's chunked scan in torch: every chunk of Lc samples at
    once (a (lanes, chunks) batch), the passes and carries of
    csrc/eqcomp.cu in order. Returns (lanes, T)."""
    lanes = vec.shape[1]
    if shared_channels:
        x_in = x_in[torch.arange(lanes) % shared_channels]
    T = x_in.shape[1]
    n = -(-T // Lc)
    X = torch.nn.functional.pad(x_in, (0, n * Lc - T)).reshape(lanes, n, Lc)
    col = [r[:, None] for r in vec]
    co = [col[5 * s:5 * s + 5] for s in range(S)]
    (eq_act, th, slope, knee, aa, ar, mk, comp_act, drive, outg,
     dist_act) = col[5 * S:5 * S + 11]

    def zeros(m):
        return [[torch.zeros(lanes, m) for _ in range(2)] for _ in range(S)]

    def flat(st):  # state rows 2s (s1) and 2s + 1 (s2), last dim
        return torch.stack([v for pair in st for v in pair], -1)

    def unflat(rows):
        return [[rows[..., 2 * s], rows[..., 2 * s + 1]] for s in range(S)]

    def blended(st, xin):
        return eq_act * _cascade(co, st, xin) + (1.0 - eq_act) * xin

    # pass A: chunks 0 .. n-2 from rest
    st = zeros(n - 1)
    for j in range(Lc):
        _cascade(co, st, X[:, :n - 1, j])
    f = flat(st)
    # carry 1: Phi's column i is the unit state e_i stepped Lc times
    unit = unflat(torch.eye(2 * S).expand(lanes, 2 * S, 2 * S).clone())
    for _ in range(Lc):
        _cascade(co, unit, torch.zeros(lanes, 2 * S))
    phi = flat(unit).transpose(1, 2)  # phi[:, r, i]
    s0 = [torch.zeros(lanes, 2 * S)]
    for k in range(n - 1):
        s0.append(torch.einsum("lri,li->lr", phi, s0[-1]) + f[:, k])
    s0 = torch.stack(s0, 1)  # (lanes, n, 2S)
    # pass B: the release steps composed over chunks 0 .. n-2
    st = unflat(s0[:, :n - 1])
    K, Bm, M = (torch.ones(lanes, n - 1), torch.zeros(lanes, n - 1),
                torch.full((lanes, n - 1), math.inf))
    for j in range(Lc):
        c = _computer(blended(st, X[:, :n - 1, j]), th, slope, knee)
        bc = (1.0 - ar) * c
        K, Bm, M = ar * K, ar * Bm + bc, torch.fmin(c, ar * M + bc)
    # carry 2
    y1 = [torch.zeros(lanes)]
    for k in range(n - 1):
        y1.append(torch.fmin(M[:, k], K[:, k] * y1[-1] + Bm[:, k]))
    y1 = torch.stack(y1, 1)
    # pass C: y1 from its carry, g from 0
    st = unflat(s0[:, :n - 1])
    y, g = y1[:, :n - 1], torch.zeros(lanes, n - 1)
    for j in range(Lc):
        c = _computer(blended(st, X[:, :n - 1, j]), th, slope, knee)
        y = torch.minimum(c, ar * y + (1.0 - ar) * c)
        g = aa * g + (1.0 - aa) * y
    # carry 3
    pw = torch.ones(lanes, 1)
    for _ in range(Lc):
        pw = aa * pw
    g0 = [torch.zeros(lanes)]
    for k in range(n - 1):
        g0.append(pw[:, 0] * g0[-1] + g[:, k])
    # pass D: every chunk from its carried state
    st = unflat(s0)
    y, g = y1, torch.stack(g0, 1)
    out = []
    for j in range(Lc):
        xin = X[:, :, j]
        v = blended(st, xin)
        c = _computer(v, th, slope, knee)
        y = torch.minimum(c, ar * y + (1.0 - ar) * c)
        g = aa * g + (1.0 - aa) * y
        o = v * torch.exp(g * eqcomp._LN10_OVER_20) * mk
        o = comp_act * o + (1.0 - comp_act) * v
        if with_dist:
            od = torch.tanh(o * drive) * outg
            o = dist_act * od + (1.0 - dist_act) * o
        out.append(o)
    return torch.stack(out, -1).reshape(lanes, n * Lc)[:, :T]


@functools.lru_cache(maxsize=None)
def _plain_pair(T, shared, with_dist):
    """Kernel inputs (74 lanes, masks mixed) and the plain version's
    float32 and float64 runs, once per input set in a worker."""
    x, b, a, kw, shared_lead = _inputs(37, 2, T, 5, shared, with_dist, True)

    def t(v):
        return torch.as_tensor(v) if isinstance(v, np.ndarray) else v

    args = eqcomp.eqcomp_inputs(t(x), t(b), t(a),
                                shared_lead_shape=shared_lead,
                                **{k: t(v) for k, v in kw.items()})[:5]
    return (args, eqcomp.eqcomp_plain(*args),
            eqcomp.eqcomp_plain(*args, dtype=torch.float64))


@pytest.mark.parametrize("T,shared,with_dist,Lc", [
    (2000, True, True, 32), (2000, True, True, 96), (2000, True, True, 512),
    (2000, False, True, 32), (2000, False, True, 96),
    (2000, False, True, 512), (2000, True, False, 96),
    (20011, True, True, 32), (20011, True, True, 96),
    (20011, True, True, 512)])
def test_chunked_model_matches_plain(T, shared, with_dist, Lc):
    args, want32, want64 = _plain_pair(T, shared, with_dist)
    got = _chunked_model(*args, Lc)
    assert got.shape == want32.shape
    # the first chunk starts from rest, as the serial chain does
    assert torch.equal(got[:, :Lc], want32[:, :Lc])
    excess = eqcomp.gate_excess(got, want32, args[1], args[2], args[3],
                                want64=want64)
    assert excess["a"] <= 0.0 and excess["b"] <= 0.0, excess


def test_minaffine_composition_matches_the_serial_release_stage():
    """The release stage y1 = min(c, ar*y1 + (1-ar)*c) composed over chunks
    as (k, b, m) triples and carried, against the serial recurrence."""
    rng = np.random.default_rng(3)
    lanes, T, Lc = 16, 4096, 96
    c = -np.abs(rng.standard_normal((lanes, T)) * 12.0)
    c[rng.random((lanes, T)) < 0.3] = 0.0
    c = torch.from_numpy(c.astype(np.float32))
    ar = torch.from_numpy(_time_constant_alpha(
        rng.uniform(10.0, 1000.0, lanes), SR).numpy().astype(np.float32))
    serial, y = [], torch.zeros(lanes)
    for t in range(T):
        y = torch.minimum(c[:, t], ar * y + (1.0 - ar) * c[:, t])
        serial.append(y)
    serial = torch.stack(serial, 1)
    y1 = torch.zeros(lanes)
    for k0 in range(0, T, Lc):
        K, B, M = torch.ones(lanes), torch.zeros(lanes), torch.full(
            (lanes,), math.inf)
        for t in range(k0, min(k0 + Lc, T)):
            bc = (1.0 - ar) * c[:, t]
            K, B, M = ar * K, ar * B + bc, torch.fmin(c[:, t], ar * M + bc)
        y1 = torch.fmin(M, K * y1 + B)
        end = serial[:, min(k0 + Lc, T) - 1]
        np.testing.assert_allclose(y1.numpy(), end.numpy(), rtol=0,
                                   atol=1e-5 * float(c.abs().max()))


@pytest.mark.parametrize("lanes,T,want", [
    (1024, 262144, 1024),   # the headline: 32 lane blocks x 256 chunks
    (74, 20011, 256),       # few lanes: the floor
    (2, 100, 256),          # T under one chunk
    (1024, 48000 * 600, 112512)])  # long audio: the chunks grow
def test_chunk_len(lanes, T, want):
    L = eqcomp.chunk_len(lanes, T)
    assert L == want and L % 32 == 0
    assert lanes * -(-T // L) * (2 * eqcomp.KERNEL_SECTIONS + 4) * 4 \
        <= 64 << 20


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False])
def test_kernel_matches_plain_on_card(cuda_device, shared):
    # 74 lanes: three 32-lane blocks, the last one ragged; T 2000 in 8
    # chunks of 256 (the last ragged), T 200 in one

    def t(v):
        return (torch.as_tensor(v, device=cuda_device)
                if isinstance(v, np.ndarray) else v)

    for T in (2000, 200):
        x, b, a, kw, shared_lead = _inputs(37, 2, T, 11, shared, True, True)
        args = eqcomp.eqcomp_inputs(t(x), t(b), t(a),
                                    shared_lead_shape=shared_lead,
                                    **{k: t(v) for k, v in kw.items()})[:5]
        want32 = eqcomp.eqcomp_plain(*args)
        want64 = eqcomp.eqcomp_plain(*args, dtype=torch.float64)
        before = eqcomp.launches
        got = _port(x, b, a, kw, shared_lead, cuda_device)
        torch.cuda.synchronize()
        assert eqcomp.launches == before + 1
        excess = eqcomp.gate_excess(got.reshape(want32.shape), want32,
                                    args[1], args[2], args[3],
                                    want64=want64)
        assert excess["a"] <= 0.0 and excess["b"] <= 0.0, (T, excess)
