"""K6 (the lone biquad-cascade EQ) as a chunked scan: a torch model of the
CUDA kernel's pass A, carry and pass D (``csrc/scan_core.cuh``
run_chunked_linear; every chunk at once) against the plain version under
the two rules of ``chunked.gate_excess``; the float64 witness of the plain
version; the shared chunk length.

The chunk carry rounds differently from the serial chain, so the kernel is
held (b) on every lane no farther from a float64 run of the plain version
than 4x the float32 run is, plus 1e-5 x max(1, the lane's peak), and (a)
within 1e-4 x max(1, peak) of the float32 plain run on every lane where
that run itself lies within 1e-4 x peak of float64 (as K7 and K8 are
held); the first chunk starts from rest, as the serial chain does, and is
equal bit for bit. The inputs put the EQ at its corners on the first
candidates: every low section at 20 Hz and Q 4 at +24 dB, at -24 dB and
alternating, one 20 Hz band at Q 4, every gain at +24 dB, every gain at
-24 dB at Q 0.1; the rest draw the basic EQ's ranges at random. The input
has a silent stretch from T/3 and, past 2048 samples, a silent second
1024, so that whole chunks start and end in silence; the bypass mask is
mixed. With those corners a carry formed and summed in float32 lies far
past rule (b) (the stacked 20 Hz sections: poles at radius 1 - 3e-4, and
states that cancel), which is why the kernel forms Phi and sums the chain
in double."""

import functools

import numpy as np
import pytest
import torch

from st_ito_torch.chain import basic_chain
from st_ito_torch.chain.executor import stage_params
from st_ito_torch.chain.responses import _eq_section_stack
from st_ito_torch.ops.kernels import chunked, scan

from tests.test_torch_scan import k6_numpy

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)

SR = 48000
B, C = 37, 2
_LOW = ["low_shelf"] + [f"band{i}" for i in range(4)]


def _cascade(co, st, v):
    """The TDF-II cascade step of the kernel and the plain version; st is a
    list of [s1, s2] per section, updated in place. Returns v."""
    for s, (b0, b1, b2, a1, a2) in enumerate(co):
        s1, s2 = st[s]
        y = b0 * v + s1
        st[s] = [b1 * v - a1 * y + s2, b2 * v - a2 * y]
        v = y
    return v


def cascade_model(x_in, vec, S, with_active, shared_channels, Lc,
                  carry_dtype=torch.float64):
    """The chunked K6 in torch, every chunk of Lc samples at once: pass A
    (chunks 0 .. n-2 from rest), the carry s_{k+1} = Phi s_k + f_k with Phi
    (the unit states stepped Lc times with input 0) and the chain's
    products and sums in ``carry_dtype`` (the kernel's: double), each sum
    in the kernel's order, the starting states rounded to float32, then
    pass D (every chunk from its state, then the bypass blend). Returns
    (lanes, T) float32."""
    lanes = vec.shape[1]
    if shared_channels:
        x_in = x_in[torch.arange(lanes) % shared_channels]
    T = x_in.shape[1]
    n = -(-T // Lc)
    R = 2 * S
    X = torch.nn.functional.pad(x_in, (0, n * Lc - T)).reshape(lanes, n, Lc)
    col = [r[:, None] for r in vec]
    co = [col[5 * s:5 * s + 5] for s in range(S)]
    # pass A
    st = [[torch.zeros(lanes, n - 1) for _ in range(2)] for _ in range(S)]
    for j in range(Lc):
        _cascade(co, st, X[:, :n - 1, j])
    f = torch.stack([v for pair in st for v in pair], -1)  # (lanes, n-1, R)
    # the carry: unit[:, i, r] is state row r of column i
    co_c = [[c.to(carry_dtype) for c in sec] for sec in co]
    eye = torch.eye(R, dtype=carry_dtype).expand(lanes, R, R).clone()
    unit = [[eye[..., 2 * s], eye[..., 2 * s + 1]] for s in range(S)]
    for _ in range(Lc):
        _cascade(co_c, unit, torch.zeros(lanes, R, dtype=carry_dtype))
    phi = torch.stack([v for pair in unit for v in pair], -1)
    s = torch.zeros(lanes, R, dtype=carry_dtype)
    starts = [s]
    for k in range(n - 1):
        acc = torch.zeros(lanes, R, dtype=carry_dtype)
        for j in range(R):
            acc = acc + phi[:, j, :] * s[:, j:j + 1]
        s = acc + f[:, k].to(carry_dtype)
        starts.append(s)
    s0 = torch.stack(starts, 1).to(torch.float32)  # (lanes, n, R)
    # pass D
    st = [[s0[..., 2 * q], s0[..., 2 * q + 1]] for q in range(S)]
    act = col[5 * S] if with_active else None
    out = []
    for j in range(Lc):
        xin = X[:, :, j]
        v = _cascade(co, st, xin)
        if act is not None:
            v = act * v + (1.0 - act) * xin
        out.append(v)
    return torch.stack(out, -1).reshape(lanes, n * Lc)[:, :T]


def k6_inputs(T, seed, shared):
    """K6's (x_in, vec, S, with_active, shared_channels) on B 37, stereo:
    the corners on candidates 0-5, the basic EQ's ranges at random on the
    rest, the silent stretches and a mixed bypass mask (candidates 0-5 on,
    the last off)."""
    rng = np.random.default_rng(seed)
    chain = basic_chain()
    eq, start, _ = chain.stage_slices()[0]
    W = torch.from_numpy(rng.random((B, chain.num_params)).astype(np.float32))
    p = stage_params(eq, W, start, 1)
    for cand, gains in ((0, [24.0] * 5), (1, [-24.0] * 5),
                        (2, [24.0, -24.0] * 2 + [24.0])):
        for name, g in zip(_LOW, gains):
            p[f"{name}_cutoff_freq"][cand] = 20.0
            p[f"{name}_q_factor"][cand] = 4.0
            p[f"{name}_gain_db"][cand] = g
        p["high_shelf_cutoff_freq"][cand] = 18000.0
        p["high_shelf_gain_db"][cand] = gains[0]
    p["band0_cutoff_freq"][3] = 20.0
    p["band0_q_factor"][3] = 4.0
    p["band0_gain_db"][3] = 24.0
    for name in _LOW + ["high_shelf"]:
        p[f"{name}_gain_db"][4] = 24.0
        p[f"{name}_gain_db"][5] = -24.0
        p[f"{name}_q_factor"][5] = 0.1
    b, a = _eq_section_stack(p, SR)
    x = (rng.standard_normal((C, T) if shared else (B, C, T)) * 0.5).astype(
        np.float32)
    x[..., T // 3:T // 3 + 1000] = 0.0
    if T > 2048:
        x[..., 1024:2048] = 0.0
    act = (rng.random(B) > 0.5).astype(np.float32)
    act[:6], act[-1] = 1.0, 0.0
    return scan.biquad_cascade_inputs(
        torch.from_numpy(x), b[:, None], a[:, None],
        active=torch.from_numpy(act)[:, None],
        shared_lead_shape=(B, C) if shared else None)[:5]


@functools.lru_cache(maxsize=None)
def _plain(T, shared):
    args = k6_inputs(T, 11, shared)
    return (args, scan.biquad_cascade_plain(*args),
            scan.biquad_cascade_plain(*args, dtype=torch.float64))


def _hold(got, want32, want64, Lc):
    """The kernel's rules: the first chunk bitwise; (b) on every lane; (a)
    on every lane where the float32 plain run lies within 1e-4 x peak of
    the float64 one."""
    assert got.shape == want32.shape
    assert torch.equal(got[:, :Lc], want32[:, :Lc])
    excess = chunked.gate_excess(got, want32, want64=want64)
    assert excess["b"] <= 0.0 and excess["a_miss_plain_near"] == 0, excess
    return excess


# T 4096 and 20011 (not a multiple of the tile) in chunks of 256 to 1024,
# and T <= Lc: one chunk, pass A on an empty grid
CASES = [(4096, 256), (4096, 512), (4096, 1024), (20011, 256), (20011, 512),
         (20011, 1024), (700, 1024), (256, 256)]


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("T,Lc", CASES)
def test_k6_chunked_model_matches_plain(T, Lc, shared):
    args, want32, want64 = _plain(T, shared)
    _hold(cascade_model(*args, Lc), want32, want64, Lc)


def test_corners_miss_rule_a_only_where_the_plain_run_does():
    """At the stacked 20 Hz corners the float32 serial chain itself lies
    past 1e-4 x peak of float64, and only there may the kernel miss (a);
    every lane of the random candidates holds it."""
    args, want32, want64 = _plain(20011, True)
    got = cascade_model(*args, 1024)
    excess = _hold(got, want32, want64, 1024)
    assert excess["a_miss_plain_far"] > 0
    assert chunked.gate_excess(got[12:], want32[12:],
                               want64=want64[12:])["a"] <= 0.0


def test_float32_carry_misses_rule_b_at_the_corners():
    """The reason for the double carry: the same scan with Phi formed and
    the chain summed in float32 lies far past rule (b) at the corners."""
    args, want32, want64 = _plain(20011, True)
    got = cascade_model(*args, 256, carry_dtype=torch.float32)
    assert chunked.gate_excess(got, want32, want64=want64)["b"] > 0.0


def test_k6_plain_float64_witness():
    """dtype=float64 runs the same cascade in float64 (the numpy replica at
    float64); the float32 default is unchanged, bit for bit."""
    args = k6_inputs(1500, 12, False)
    x_in, vec, S, with_active, _ = args
    got32 = scan.biquad_cascade_plain(*args)
    assert got32.dtype == torch.float32
    assert torch.equal(got32, scan.biquad_cascade_plain(
        *args, dtype=torch.float32))
    co = vec[:5 * S].T.reshape(-1, S, 5).numpy()
    b = co[..., :3]
    a = np.concatenate([np.ones_like(co[..., :1]), co[..., 3:]], -1)
    act = vec[5 * S].numpy() if with_active else None
    np.testing.assert_array_equal(
        got32.numpy(), k6_numpy(x_in.numpy(), b, a, act, np.float32))
    got64 = scan.biquad_cascade_plain(*args, dtype=torch.float64)
    assert got64.dtype == torch.float64
    np.testing.assert_array_equal(
        got64.numpy(), k6_numpy(x_in.numpy(), b, a, act, np.float64))


@pytest.mark.parametrize("lanes,T,want", [
    (1024, 262144, 1024),   # the CLI's headline: 32 lane blocks x 256 chunks
    (74, 20011, 256),       # few lanes: the floor
    (37, 100, 256),         # T under one chunk
    (1024, 48000 * 600, 112512)])  # long audio: 256 longer chunks
def test_cascade_chunk_len(lanes, T, want):
    L = scan.cascade_chunk_len(lanes, T)
    assert L == want and L % 32 == 0
    assert lanes * -(-T // L) * scan.CASCADE_ROWS * 4 <= chunked.TABLE_CAP
    assert L == chunked.chunk_len(lanes, T, scan.CASCADE_ROWS)


def test_rule_a_excuse_counts_only_near_misses_past_the_factor():
    """a_miss_unexcused counts the lanes that miss (a) while the float32
    plain run lies within 1e-4 x peak of float64 and the kernel lies
    farther than A_EXCUSE x that run's distance from float64: lane 0 holds
    (a), lane 1 misses it with the plain run far from float64, lane 2 near
    it and the kernel about as near (excused), lane 3 near it and the
    kernel much farther (not excused)."""
    T = 64
    want64 = torch.zeros((4, T), dtype=torch.float64)
    want64[:, 0] = 2.0  # peak 2: (a)'s limit 2e-4
    want32 = want64.clone()
    want32[:, 5] = torch.tensor([0.0, 5e-4, 1.5e-4, 1.0e-4],
                                dtype=torch.float64)
    got = want32.clone()
    got[:, 5] = torch.tensor([1e-4, -1e-4, -1.6e-4, -2.5e-4],
                             dtype=torch.float64)
    excess = chunked.gate_excess(got.float(), want32.float(), want64=want64)
    assert excess["a_miss_plain_far"] == 1
    assert excess["a_miss_plain_near"] == 2
    assert excess["a_miss_unexcused"] == 1
    # within the factor on the near lanes: nothing unexcused
    got[3, 5] = -1.2e-4
    excess = chunked.gate_excess(got.float(), want32.float(), want64=want64)
    assert (excess["a_miss_plain_near"], excess["a_miss_unexcused"]) == (2, 0)
