"""K7 (the whole unlinked compressor) and K8 (the lone compressor
ballistics) as chunked scans: a torch model of the CUDA kernels' passes and
carries (``csrc/scan_core.cuh`` run_chunked_detector; every chunk at once)
against the plain versions under the two rules of ``chunked.gate_excess``;
the float64 witness of the plain versions; the min-affine composition at
release coefficients near 0 and near 1; the shared chunk length.

The chunk carries round differently from the serial chain, so the kernels
are held (a) on every lane within 1e-4 x max(1, the lane's peak) of the
float32 plain run, and (b) on every lane no farther from a float64 run of
the plain version than 4x the float32 run is, plus 1e-5 x max(1, peak);
the first chunk starts from rest, as the serial chain does, and is equal
bit for bit. The inputs put release coefficients at 0 and just above it
and at the chain's longest release (1000 ms) and beyond it (8 s), where the
float32 serial chain itself drifts most, and attack coefficients near 0
and 1; K8's c has chunks that are all zeros and chunks with none, K7's
input a silent stretch (the gain computer's 1e-8 floor) in which a chunk
starts."""

import functools
import math

import numpy as np
import pytest
import torch

from st_ito_torch.ops.dynamics import _time_constant_alpha
from st_ito_torch.ops.kernels import chunked, scan

from tests.test_torch_scan import k7_numpy, k8_numpy

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)

SR = 48000
LANES = 37
# per-lane (aa, ar) overrides on the first lanes: release near 0, at the
# chain's longest release and beyond it; attack near 0 and near 1
EDGE_AR = (0.0, 1e-6, 1e-3, float(_time_constant_alpha(1000.0, SR)),
           float(_time_constant_alpha(8000.0, SR)))
EDGE_AA = (0.0, 1e-6, float(_time_constant_alpha(2000.0, SR)))


def pow_n(x: torch.Tensor, n: int) -> torch.Tensor:
    """scan_core.cuh pow_n: x^n by squaring in float64, rounded once."""
    r, b = torch.ones_like(x, dtype=torch.float64), x.to(torch.float64)
    while n > 0:
        if n & 1:
            r = r * b
        b = b * b
        n >>= 1
    return r.to(torch.float32)


def detector_model(x_in, aa, ar, front, tail, Lc):
    """The chunked detector in torch, every chunk of Lc samples at once:
    pass B (the release map, k = pow_n(ar, Lc)), carry 1, pass C, carry 2
    (through pow_n(aa, Lc)), pass D, as run_chunked_detector orders them.
    x_in (lanes, T); aa, ar (lanes,); front(x) the gain computer's c and
    tail(x, g) the output, each on (lanes, ...) blocks. Returns
    (lanes, T)."""
    lanes, T = x_in.shape
    n = -(-T // Lc)
    X = torch.nn.functional.pad(x_in, (0, n * Lc - T)).reshape(lanes, n, Lc)
    C = front(X)
    aa, ar = aa[:, None], ar[:, None]
    # pass B: chunks 0 .. n-2 from rest
    M, Bm = torch.full((lanes, n - 1), math.inf), torch.zeros(lanes, n - 1)
    for j in range(Lc):
        c = C[:, :n - 1, j]
        bc = (1.0 - ar) * c
        Bm, M = ar * Bm + bc, torch.fmin(c, ar * M + bc)
    K = pow_n(ar, Lc)[:, 0]
    # carry 1
    y1 = [torch.zeros(lanes)]
    for k in range(n - 1):
        y1.append(torch.fmin(M[:, k], K * y1[-1] + Bm[:, k]))
    y1 = torch.stack(y1, 1)
    # pass C: y1 from its carry, g from 0
    y, g = y1[:, :n - 1], torch.zeros(lanes, n - 1)
    for j in range(Lc):
        c = C[:, :n - 1, j]
        y = torch.minimum(c, ar * y + (1.0 - ar) * c)
        g = aa * g + (1.0 - aa) * y
    # carry 2
    pw = pow_n(aa, Lc)[:, 0]
    g0 = [torch.zeros(lanes)]
    for k in range(n - 1):
        g0.append(pw * g0[-1] + g[:, k])
    # pass D: every chunk from its carried state
    y, g = y1, torch.stack(g0, 1)
    G = []
    for j in range(Lc):
        c = C[:, :, j]
        y = torch.minimum(c, ar * y + (1.0 - ar) * c)
        g = aa * g + (1.0 - aa) * y
        G.append(g)
    return tail(X, torch.stack(G, -1)).reshape(lanes, n * Lc)[:, :T]


def k8_model(c_in, vec, Lc):
    return detector_model(c_in, vec[0], vec[1], lambda c: c,
                          lambda c, g: g, Lc)


def k7_model(x_in, vec, with_active, Lc):
    th, slope, knee, aa, ar, mk = vec[:6]
    col = [v[:, None, None] for v in (th, slope, knee, mk)]
    th, slope, knee, mk = col

    def front(x):
        env_db = torch.log(torch.clamp_min(x.abs(), 1e-8)) * scan._DB_PER_LOG
        over = env_db - th
        h = over + knee / 2.0
        knee_region = slope * (h * h) / (2.0 * knee)
        return torch.where(2.0 * over < -knee, torch.zeros_like(over),
                           torch.where(2.0 * over > knee, slope * over,
                                       knee_region))

    def tail(x, g):
        y = x * torch.exp(g * scan._LN10_OVER_20) * mk
        if with_active:
            act = vec[6][:, None, None]
            y = act * y + (1.0 - act) * x
        return y

    return detector_model(x_in, aa, ar, front, tail, Lc)


def k8_inputs(T, seed):
    """(c_in, vec) on 37 lanes: gain-computer-like dB values, in blocks of
    1024 samples (a multiple of every chunk length here) that are all
    zeros, hold no zero, or hold a third of zeros, and the edge
    coefficients on the first lanes."""
    rng = np.random.default_rng(seed)
    c = -np.abs(rng.standard_normal((LANES, T)) * 12.0)
    kind = rng.integers(0, 3, (LANES, -(-T // 1024)))
    kind[:, 0] = np.arange(LANES) % 3
    zero = np.repeat(kind, 1024, axis=1)[:, :T]
    c[zero == 0] = 0.0
    c[(zero == 2) & (rng.random((LANES, T)) < 0.33)] = 0.0
    aa = _time_constant_alpha(rng.uniform(0.05, 100.0, LANES), SR)
    ar = _time_constant_alpha(rng.uniform(10.0, 1000.0, LANES), SR)
    ar[:len(EDGE_AR)] = torch.tensor(EDGE_AR)
    aa[len(EDGE_AR):len(EDGE_AR) + len(EDGE_AA)] = torch.tensor(EDGE_AA)
    c_in, vec, _ = scan.ballistics_inputs(
        torch.from_numpy(c.astype(np.float32)), aa, ar)
    return c_in, vec


def k7_inputs(T, seed, with_active):
    """(x_in, vec, with_active) on 37 lanes: noise with 1000 silent samples
    from T/3, the compressor stage's parameter ranges, the edge
    coefficients on the first lanes and, with the bypass row, a mixed
    mask."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((LANES, T)) * 0.5).astype(np.float32)
    x[:, T // 3:T // 3 + 1000] = 0.0

    def col(lo, hi):
        return torch.from_numpy(rng.uniform(lo, hi, LANES).astype(np.float32))

    act = (rng.random(LANES) > 0.5).astype(np.float32)
    act[0], act[-1] = 1.0, 0.0
    x_in, vec, with_active, _ = scan.compressor_fused_inputs(
        torch.from_numpy(x), col(-40.0, -5.0), col(1.0, 20.0), col(0.0, 6.0),
        _time_constant_alpha(col(0.1, 100.0), SR),
        _time_constant_alpha(col(10.0, 1000.0), SR), col(-3.0, 3.0),
        active=torch.from_numpy(act) if with_active else None)
    vec[4, :len(EDGE_AR)] = torch.tensor(EDGE_AR)
    vec[3, len(EDGE_AR):len(EDGE_AR) + len(EDGE_AA)] = torch.tensor(EDGE_AA)
    return x_in, vec, with_active


@functools.lru_cache(maxsize=None)
def _k8_plain(T):
    c_in, vec = k8_inputs(T, 3)
    return ((c_in, vec), scan.ballistics_plain(c_in, vec),
            scan.ballistics_plain(c_in, vec, dtype=torch.float64))


@functools.lru_cache(maxsize=None)
def _k7_plain(T, with_active):
    args = k7_inputs(T, 4, with_active)
    return (args, scan.compressor_fused_plain(*args),
            scan.compressor_fused_plain(*args, dtype=torch.float64))


def _hold(got, want32, want64, Lc):
    assert got.shape == want32.shape
    # the first chunk starts from rest, as the serial chain does
    assert torch.equal(got[:, :Lc], want32[:, :Lc])
    excess = chunked.gate_excess(got, want32, want64=want64)
    assert excess["a"] <= 0.0 and excess["b"] <= 0.0, excess


# T 4096 and 20011 (not a multiple of the tile) in chunks of 256 to 1024,
# and T <= Lc: one chunk, passes B and C on an empty grid
CASES = [(4096, 256), (4096, 512), (4096, 1024), (20011, 256), (20011, 512),
         (20011, 1024), (700, 1024), (256, 256)]


@pytest.mark.parametrize("T,Lc", CASES)
def test_k8_chunked_model_matches_plain(T, Lc):
    (c_in, vec), want32, want64 = _k8_plain(T)
    _hold(k8_model(c_in, vec, Lc), want32, want64, Lc)


@pytest.mark.parametrize("with_active", [True, False])
@pytest.mark.parametrize("T,Lc", CASES)
def test_k7_chunked_model_matches_plain(T, Lc, with_active):
    args, want32, want64 = _k7_plain(T, with_active)
    _hold(k7_model(*args, Lc), want32, want64, Lc)


@pytest.mark.parametrize("ar", EDGE_AR)
@pytest.mark.parametrize("zeros", ["all", "none", "third"])
def test_release_map_matches_the_serial_release_stage(ar, zeros):
    """The release stage y1 = min(c, ar*y1 + (1-ar)*c) over chunks of 512
    as the kernel composes it (b and m step by step, k = pow_n(ar, 512))
    and carries it, against the serial recurrence in float32 and float64:
    within 4x the float32 chain's own distance from float64, plus 1e-5 x
    peak, at every chunk's end."""
    rng = np.random.default_rng(5)
    lanes, T, Lc = 8, 8192, 512
    c = -np.abs(rng.standard_normal((lanes, T)) * 12.0)
    if zeros == "all":  # every other chunk all zeros, the rest none
        for k0 in range(0, T, 2 * Lc):
            c[:, k0:k0 + Lc] = 0.0
    elif zeros == "third":
        c[rng.random((lanes, T)) < 0.33] = 0.0
    c = torch.from_numpy(c.astype(np.float32))
    arv = torch.full((lanes,), ar, dtype=torch.float32)

    def serial(dtype):
        y, out = torch.zeros(lanes, dtype=dtype), []
        a, cc = arv.to(dtype), c.to(dtype)
        for t in range(T):
            y = torch.minimum(cc[:, t], a * y + (1.0 - a) * cc[:, t])
            out.append(y)
        return torch.stack(out, 1)

    s32, s64 = serial(torch.float32), serial(torch.float64)
    y1, ends = torch.zeros(lanes), []
    K = pow_n(arv, Lc)
    for k0 in range(0, T, Lc):
        B, M = torch.zeros(lanes), torch.full((lanes,), math.inf)
        for t in range(k0, k0 + Lc):
            bc = (1.0 - arv) * c[:, t]
            B, M = arv * B + bc, torch.fmin(c[:, t], arv * M + bc)
        y1 = torch.fmin(M, K * y1 + B)
        ends.append(y1)
    got = torch.stack(ends, 1).double()
    want32 = s32[:, Lc - 1::Lc].double()
    want64 = s64[:, Lc - 1::Lc]
    peak = float(c.abs().max())
    limit = 4.0 * float((want32 - want64).abs().max()) + 1e-5 * peak
    assert float((got - want64).abs().max()) <= limit


def test_k8_plain_float64_witness():
    """dtype=float64 runs the same recurrence in float64 (the numpy
    replica at float64); the float32 default is unchanged, bit for bit."""
    c_in, vec = k8_inputs(3000, 6)
    c, aa, ar = c_in.numpy(), vec[0].numpy(), vec[1].numpy()
    got32 = scan.ballistics_plain(c_in, vec)
    assert got32.dtype == torch.float32
    assert torch.equal(got32, scan.ballistics_plain(c_in, vec,
                                                    dtype=torch.float32))
    np.testing.assert_array_equal(got32.numpy(),
                                  k8_numpy(c, aa, ar, np.float32))
    got64 = scan.ballistics_plain(c_in, vec, dtype=torch.float64)
    assert got64.dtype == torch.float64
    np.testing.assert_array_equal(got64.numpy(),
                                  k8_numpy(c, aa, ar, np.float64))


@pytest.mark.parametrize("with_active", [True, False])
def test_k7_plain_float64_witness(with_active):
    x_in, vec, _ = k7_inputs(3000, 7, with_active)
    got32 = scan.compressor_fused_plain(x_in, vec, with_active)
    assert torch.equal(got32, scan.compressor_fused_plain(
        x_in, vec, with_active, dtype=torch.float32))
    np.testing.assert_array_equal(
        got32.numpy(), k7_numpy(x_in.numpy(), vec.numpy(), with_active,
                                np.float32))
    got64 = scan.compressor_fused_plain(x_in, vec, with_active,
                                        dtype=torch.float64)
    assert got64.dtype == torch.float64
    # float64 log and exp: torch's and numpy's may differ in the last bit
    np.testing.assert_allclose(
        got64.numpy(), k7_numpy(x_in.numpy(), vec.numpy(), with_active,
                                np.float64), rtol=1e-13, atol=1e-300)
    # the float32 run lies close to the float64 one
    assert float((got32.double() - got64).abs().max()) < 1e-4


@pytest.mark.parametrize("lanes,T,want", [
    (512, 262144, 512),     # K8's headline: 16 lane blocks x 512 chunks
    (1024, 262144, 1024),   # K7's headline: 32 lane blocks x 256 chunks
    (74, 20011, 256),       # few lanes: the floor
    (37, 100, 256),         # T under one chunk
    (1024, 48000 * 600, 112512)])  # long audio: 256 longer chunks
def test_detector_chunk_len(lanes, T, want):
    L = scan.detector_chunk_len(lanes, T)
    assert L == want and L % 32 == 0
    assert lanes * -(-T // L) * scan.DETECTOR_ROWS * 4 <= chunked.TABLE_CAP
    assert L == chunked.chunk_len(lanes, T, scan.DETECTOR_ROWS)


def test_gate_excess_rules():
    """Rule (a) on the masked lanes only; rule (b) against float64; the
    count of lanes that miss (a) where the float32 run itself is far."""
    want64 = torch.linspace(-2.0, 2.0, 40, dtype=torch.float64).repeat(3, 1)
    want32 = want64.float()
    got = want32.clone()
    assert chunked.gate_excess(got, want32, want64)["a"] < 0
    got[1, 5] += 1e-3  # past (a) on lane 1; within 4x (b) nowhere
    ex = chunked.gate_excess(got, want32, want64)
    assert ex["a"] > 0 and ex["b"] > 0
    assert ex["a_miss_plain_near"] == 1 and ex["a_miss_plain_far"] == 0
    mask = torch.tensor([True, False, True])
    assert chunked.gate_excess(got, want32, rule_a_lanes=mask)["a"] < 0
