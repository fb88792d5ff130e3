"""K11 (the linear recurrence, the phaser's allpasses) as a chunked scan: a
torch model of the CUDA kernel's pass A, carry and pass D (``csrc/scan.cu``
run_chunked_recurrence; every chunk at once) against the plain version
under the two rules of ``chunked.gate_excess``; the float64 witness of the
plain version; the chunk length.

y = a*y + b varies in time, so chunk k's transition is y -> P_k y + z_k
with P_k the product of the chunk's a (formed in float64, one product a
sample, rounded once to float32) and z_k its end value from rest (float32,
in the step's own order); the carry y_{k+1} = P_k y_k + z_k runs in
float64 and each chunk's starting value is rounded to float32. That rounds
differently from the serial chain after the first chunk, so the kernel is
held (b) on every lane no farther from a float64 run of the plain version
than 4x the float32 run is, plus 1e-5 x max(1, the lane's peak), and (a)
within 1e-4 x max(1, peak) of the float32 plain run on every lane where
that run itself lies within 1e-4 x peak of float64; the first chunk starts
from 0, as the serial chain does, and is equal bit for bit. The inputs are
``k11_case``'s (a long memory, a random drive), ``k11_long_case``'s (a
longer one, where a carry without the chunk products must miss the
rules), the phaser's own six stages (``ops/delay.py phaser``: its
coefficient at the 20 Hz floor of its sweep, where it lies within 3e-3 of
1, and across the whole sweep up to 0.49 x the sample rate, where it is
negative) and a drive with silent stretches that whole chunks start and
end in."""

import functools

import numpy as np
import pytest
import torch

from st_ito_torch.ops import delay
from st_ito_torch.ops.kernels import chunked, scan

from tests.test_torch_scan import k11_case, k11_long_case, k11_numpy
from tests.torch_jax_cache import shared_compile_cache  # noqa: F401

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)

SR = 48000


def recurrence_model(a_in, b_in, Lc, drop_p=False):
    """The chunked K11 in torch, every chunk of Lc samples at once: pass A
    (chunks 0 .. n-2 from rest: z_k in float32, P_k in float64 rounded to
    float32), the carry in float64 with each start rounded to float32,
    then pass D (every chunk from its start). Returns (lanes, T)
    float32. ``drop_p`` breaks the carry: P_k = 0, each start z_k."""
    lanes, T = a_in.shape
    n = -(-T // Lc)
    A, B = (torch.nn.functional.pad(v, (0, n * Lc - T)).reshape(lanes, n, Lc)
            for v in (a_in, b_in))
    # pass A
    z = torch.zeros(lanes, n - 1)
    P = torch.ones(lanes, n - 1, dtype=torch.float64)
    for j in range(Lc):
        z = A[:, :n - 1, j] * z + B[:, :n - 1, j]
        P = P * A[:, :n - 1, j].to(torch.float64)
    P = P.to(torch.float32).to(torch.float64)
    if drop_p:
        P = torch.zeros_like(P)
    # the carry
    y = torch.zeros(lanes, dtype=torch.float64)
    starts = [y]
    for k in range(n - 1):
        y = P[:, k] * y + z[:, k].to(torch.float64)
        starts.append(y)
    y = torch.stack(starts, 1).to(torch.float32)
    # pass D
    out = []
    for j in range(Lc):
        y = A[:, :, j] * y + B[:, :, j]
        out.append(y)
    return torch.stack(out, -1).reshape(lanes, n * Lc)[:, :T]


def _hold(a_in, b_in, Lc):
    """The kernel's rules on the model: the first chunk bitwise; (b) on
    every lane; (a) on every lane where the float32 plain run lies within
    1e-4 x peak of the float64 one."""
    want32 = scan.linear_recurrence_plain(a_in, b_in)
    want64 = scan.linear_recurrence_plain(a_in, b_in, dtype=torch.float64)
    got = recurrence_model(a_in, b_in, Lc)
    assert got.shape == want32.shape and got.dtype == torch.float32
    assert torch.equal(got[:, :Lc], want32[:, :Lc])
    excess = chunked.gate_excess(got, want32, want64=want64)
    assert excess["b"] <= 0.0 and excess["a_miss_plain_near"] == 0, excess
    return excess


# T 4096 and 20011 (not a multiple of the tile) in chunks of 256 to 1024,
# and T <= Lc: one chunk, pass A on an empty grid
CASES = [(4096, 256), (4096, 1024), (20011, 256), (20011, 1024), (700, 1024),
         (256, 256)]


@pytest.mark.parametrize("T,Lc", CASES)
def test_k11_chunked_model_matches_plain(T, Lc):
    a, b = k11_case(37, T, 3)
    _hold(torch.from_numpy(a), torch.from_numpy(b), Lc)


@functools.lru_cache(maxsize=None)
def _phaser_stages(T):
    """The (coeff, drive) that each of the phaser's 6 allpasses gives K11,
    from ``ops/delay.py phaser`` on 6 candidates x stereo: at the 20 Hz
    floor of the sweep (a fixed 20 Hz, and a sweep from 15 Hz clamped to
    20), across the registry's ranges, and up to 16 kHz (a negative
    coefficient)."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.standard_normal((6, 2, T)) * 0.5)
                         .astype(np.float32))
    rate = [1.0, 7.0, 0.1, 3.3, 0.5, 10.0]
    depth = [0.0, 1.0, 0.5, 1.0, 0.8, 1.0]
    centre = [20.0, 30.0, 100.0, 1300.0, 5000.0, 8000.0]

    def col(v):
        return torch.tensor(v, dtype=torch.float32)[:, None, None]

    seen = []
    real = scan.linear_recurrence_plain

    def watch(a_in, b_in):
        seen.append((a_in, b_in))
        return real(a_in, b_in)

    scan.linear_recurrence_plain = watch
    try:
        delay.phaser(x, SR, col(rate), col(depth), col(centre), col([0.5] * 6),
                     col([1.0] * 6), fast=True)
    finally:
        scan.linear_recurrence_plain = real
    assert len(seen) == 6
    return seen


@pytest.mark.parametrize("T,Lc", [(4096, 256), (20011, 256), (20011, 1024)])
def test_k11_chunked_model_on_the_phasers_stages(T, Lc):
    stages = _phaser_stages(T)
    a0 = stages[0][0]
    # lanes 0-1 sit at the floor: -a_prev at 20 Hz, within 3e-3 of 1
    assert float((1.0 - a0[:2, 1:]).abs().max()) < 3e-3
    assert float(a0[:2, 1:].min()) > 0.997
    assert float(a0[-2:].min()) < 0.0  # 16 kHz: the coefficient is negative
    for a_in, b_in in stages:
        _hold(a_in, b_in, Lc)


def test_k11_chunked_model_with_silent_stretches():
    """A drive that is 0 over whole chunks (z_k exactly 0) and over a
    stretch that a chunk boundary cuts, with k11_case's coefficient."""
    T = 20011
    a, b = k11_case(37, T, 4)
    b[:, 1024:2048] = 0.0
    b[:, T // 3:T // 3 + 1000] = 0.0
    b[:, 7000:] *= 1e-3  # a quiet tail
    _hold(torch.from_numpy(a), torch.from_numpy(b), 256)


def test_k11_chunked_model_with_a_long_memory():
    """Each lane's coefficient fixed in [0.999, 0.99999] (the phaser's
    allpass with its sweep held, a longer memory than its 20 Hz floor), so
    that the carry's term P_k y_k is most of each chunk's start: the model
    holds the rules, and with P_k dropped from its carry it misses them on
    every lane."""
    a, b = (torch.from_numpy(v) for v in k11_long_case(37, 20011, 6))
    _hold(a, b, 256)
    want32 = scan.linear_recurrence_plain(a, b)
    want64 = scan.linear_recurrence_plain(a, b, dtype=torch.float64)
    excess = chunked.gate_excess(recurrence_model(a, b, 256, drop_p=True),
                                 want32, want64=want64)
    assert excess["b"] > 0.0 and excess["a_miss_plain_near"] == 37, excess


def test_k11_plain_float64_witness():
    """dtype=float64 runs the same recurrence in float64 (the numpy replica
    at float64); the float32 default is unchanged, bit for bit."""
    a, b = k11_case(5, 1500, 12)
    a_in, b_in = torch.from_numpy(a), torch.from_numpy(b)
    got32 = scan.linear_recurrence_plain(a_in, b_in)
    assert got32.dtype == torch.float32
    np.testing.assert_array_equal(got32.numpy(), k11_numpy(a, b, np.float32))
    got64 = scan.linear_recurrence_plain(a_in, b_in, dtype=torch.float64)
    assert got64.dtype == torch.float64
    np.testing.assert_array_equal(got64.numpy(), k11_numpy(a, b, np.float64))


@pytest.mark.parametrize("lanes,T,want", [
    (1024, 262144, 1024),   # the fx chain's headline: 32 lane blocks x 256
    (74, 20011, 256),       # few lanes: the floor
    (37, 100, 256),         # T under one chunk
    (1024, 48000 * 600, 112512)])  # long audio: 256 longer chunks
def test_linrec_chunk_len(lanes, T, want):
    L = scan.linrec_chunk_len(lanes, T)
    assert L == want and L % 32 == 0
    assert lanes * -(-T // L) * scan.RECURRENCE_ROWS * 4 <= chunked.TABLE_CAP
    assert L == chunked.chunk_len(lanes, T, scan.RECURRENCE_ROWS)
