"""K6 (the lone biquad-cascade EQ), K7 (the whole unlinked compressor), K8
(the lone compressor ballistics) and K11 (the linear recurrence): the port's
plain PyTorch versions against st_ito_tpu's biquad_cascade_pallas,
compressor_fused_pallas, ballistics_pallas and linear_recurrence_pallas run
in interpret mode, and (on a card only) the CUDA kernels against the plain
versions.

Tolerances. The plain versions equal, bit for bit, a numpy float32 replica
of the TPU kernels' arithmetic (``scan.py:71-77``, ``:109-123``,
``:400-431``, ``:478-487``) that rounds every product and every sum, which
is what the CUDA kernels compute under ``-fmad=false``; K7's replica takes
its log and exp from torch on an array of the plain version's shape, since
numpy's and torch's float32 transcendentals may differ in the last bit.
XLA on the CPU, which runs the Pallas kernels in interpret mode, contracts
each a*b + c into one fused multiply-add (``jax.jit(lambda a, b, c: a * b +
c)`` equals the fused result on every one of 1e5 random float32 triples and
the unfused one on 77% of them), so against JAX the limit is 5e-5 x the
output's peak: measured 5.5e-5 on K6's 3.77 peak (a low, high-Q section
amplifies the rounding) and 2.3e-5 on K8's 29.4. From a float64 run of the
same recurrences the port stays within 1.5x of JAX's distance (K6 6.6e-5
against JAX's 7.4e-5, K8 2.2e-5 against 1.6e-5; K7 7.1e-7 against 8.2e-7
on a 1.9 peak, K11 2.1e-6 against 1.7e-6 on 10.6). On the card K6, K7,
K8 and K11, chunked scans whose carries round differently from the serial
chain, are held by the two rules of ``chunked.gate_excess`` against
float32 and float64 runs of the plain versions, with the first chunk bit
for bit (``test_torch_biquad_chunked``, ``test_torch_dynamics_chunked``
and ``test_torch_linrec_chunked`` hold torch models of their passes to
the same rules on the CPU)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from st_ito_tpu.ops.pallas.scan import (ballistics_pallas,
                                        biquad_cascade_pallas,
                                        compressor_fused_pallas,
                                        linear_recurrence_pallas)

from st_ito_torch.chain import basic_chain
from st_ito_torch.chain.executor import stage_params
from st_ito_torch.chain.responses import _eq_section_stack
from st_ito_torch.ops.dynamics import _time_constant_alpha
from st_ito_torch.ops.kernels import chunked, scan

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)

SR = 48000


def k6_case(B, C, T, seed, shared):
    """x (shared (C, T) or (B, C, T)), the basic EQ's (B, 1, 6, 3) sections
    from random raw parameters, and a (B, 1) mask with the EQ on in some
    candidates and bypassed in the others."""
    rng = np.random.default_rng(seed)
    chain = basic_chain()
    eq, start, _ = chain.stage_slices()[0]
    W = torch.from_numpy(rng.random((B, chain.num_params)).astype(np.float32))
    b, a = _eq_section_stack(stage_params(eq, W, start, 1), SR)
    x = (rng.standard_normal((C, T) if shared else (B, C, T)) * 0.5).astype(
        np.float32)
    act = (rng.random(B) > 0.5).astype(np.float32)
    act[0], act[-1] = 1.0, 0.0
    return x, b[:, None].numpy(), a[:, None].numpy(), act[:, None]


def k8_case(lanes, T, seed):
    """Gain-computer-like dB values (<= 0, a third exactly 0) and per-lane
    attack/release coefficients over the style chain's time ranges, each
    float32 exp(-1 / (ms x 0.001 x SR)) (torch's float32 exp on the CPU:
    the inputs this case has always had; ``_time_constant_alpha`` now
    rounds a float64 exp, one ulp away on one of these lanes)."""
    rng = np.random.default_rng(seed)
    c = -np.abs(rng.standard_normal((lanes, T)) * 12.0)
    c[rng.random((lanes, T)) < 0.33] = 0.0

    def alpha(ms):
        ms = torch.as_tensor(ms, dtype=torch.float32)
        return torch.exp(-1.0 / (ms * 0.001 * SR)).numpy()

    aa = alpha(rng.uniform(0.05, 100.0, lanes))
    ar = alpha(rng.uniform(10.0, 1000.0, lanes))
    return c.astype(np.float32), aa, ar


def k7_case(B, C, T, seed):
    """x (B, C, T) with silent stretches (the gain computer's 1e-8 floor),
    the compressor stage's parameter ranges as (B, 1) columns, a random
    knee and makeup, and a (B, 1) mask with the compressor on in some
    candidates and bypassed in the others."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, C, T)) * 0.5).astype(np.float32)
    x[..., T // 3:T // 3 + 50] = 0.0

    def col(lo, hi):
        return rng.uniform(lo, hi, (B, 1)).astype(np.float32)

    kw = dict(threshold_db=col(-40.0, -5.0), ratio=col(1.0, 20.0),
              knee_db=col(0.0, 6.0),
              alpha_attack=_time_constant_alpha(
                  torch.from_numpy(col(0.1, 100.0)), SR).numpy(),
              alpha_release=_time_constant_alpha(
                  torch.from_numpy(col(10.0, 1000.0)), SR).numpy(),
              makeup_gain_db=col(-3.0, 3.0))
    act = (rng.random(B) > 0.5).astype(np.float32)
    act[0], act[-1] = 1.0, 0.0
    return x, kw, act[:, None]


def _torch_f32(fn):
    return lambda v: fn(torch.from_numpy(np.ascontiguousarray(v))).numpy()


def k7_numpy(x, vec, with_active, dtype):
    """scan.py:400-431 in numpy at ``dtype`` on the kernel's (lanes, T)
    input and (6 [+ 1], lanes) table; at float32 log and exp are torch's."""
    log, exp = ((_torch_f32(torch.log), _torch_f32(torch.exp))
                if dtype == np.float32 else (np.log, np.exp))
    x, vec = np.asarray(x, dtype), np.asarray(vec, dtype)
    th, slope, knee, aa, ar, mk = (v[:, None] for v in vec[:6])
    two = dtype(2.0)
    env_db = log(np.maximum(np.abs(x), dtype(1e-8))) * dtype(
        20.0 / np.log(10.0))
    over = env_db - th
    h = over + knee / two
    knee_region = slope * (h * h) / (two * knee)
    c = np.where(two * over < -knee, dtype(0.0),
                 np.where(two * over > knee, slope * over, knee_region))
    g = k8_numpy(c, aa[:, 0], ar[:, 0], dtype)
    y = x * exp(g * dtype(np.log(10.0) / 20.0)) * mk
    if with_active:
        act = vec[6][:, None]
        y = act * y + (dtype(1.0) - act) * x
    return y


def k11_numpy(a, b, dtype):
    """scan.py:478-487 in numpy at ``dtype``: y = a*y + b from 0."""
    a, b = np.asarray(a, dtype), np.asarray(b, dtype)
    y = np.zeros(a.shape[0], dtype)
    out = np.empty_like(a)
    for t in range(a.shape[1]):
        y = a[:, t] * y + b[:, t]
        out[:, t] = y
    return out


def k11_case(lanes, T, seed):
    """A decaying coefficient near 1 (a long memory) and a random drive."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.9, 0.999, (lanes, T)).astype(np.float32)
    b = rng.standard_normal((lanes, T)).astype(np.float32)
    return a, b


def k11_long_case(lanes, T, seed):
    """A longer memory: each lane's coefficient fixed in [0.999, 0.99999],
    so that a chunk's product of coefficients is most of the carried state
    (0.77 to 0.998 over 256 samples); a random drive."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.999, 0.99999, (lanes, 1)).astype(np.float32)
    b = rng.standard_normal((lanes, T)).astype(np.float32)
    return np.ascontiguousarray(np.broadcast_to(a, (lanes, T))), b


def k6_numpy(x, b, a, act, dtype):
    """scan.py:109-123 in numpy at ``dtype``, every product and sum rounded
    on its own. x (L, T); b, a (L, S, 3); act (L,) or None."""
    x, b, a = (np.asarray(v, dtype) for v in (x, b, a))
    L, T = x.shape
    S = b.shape[1]
    st = np.zeros((L, S, 2), dtype)
    out = np.empty((L, T), dtype)
    one = dtype(1.0)
    for t in range(T):
        v = x[:, t]
        for s in range(S):
            y = b[:, s, 0] * v + st[:, s, 0]
            st[:, s, 0] = b[:, s, 1] * v - a[:, s, 1] * y + st[:, s, 1]
            st[:, s, 1] = b[:, s, 2] * v - a[:, s, 2] * y
            v = y
        if act is not None:
            v = act * v + (one - act) * x[:, t]
        out[:, t] = v
    return out


def k8_numpy(c, aa, ar, dtype):
    """scan.py:71-77 in numpy at ``dtype``. c (L, T); aa, ar (L,)."""
    c, aa, ar = (np.asarray(v, dtype) for v in (c, aa, ar))
    y1 = np.zeros(c.shape[0], dtype)
    g = np.zeros(c.shape[0], dtype)
    out = np.empty_like(c)
    one = dtype(1.0)
    for t in range(c.shape[1]):
        y1 = np.minimum(c[:, t], ar * y1 + (one - ar) * c[:, t])
        g = aa * g + (one - aa) * y1
        out[:, t] = g
    return out


def assert_matches_jax(got, want, f64):
    """Within 5e-5 x peak of the JAX kernel (its multiply-adds are fused on
    the CPU), and within 1.5x of its distance from float64."""
    peak = np.abs(want).max()
    assert np.abs(got - want).max() <= 5e-5 * peak
    assert np.abs(got - f64).max() <= 1.5 * np.abs(want - f64).max()


@pytest.mark.parametrize("masked", [True, False])
def test_k6_plain_matches_pallas_interpret(masked):
    """T 1300 against t_block 512: a ragged last block; every lane's state
    crosses two block boundaries."""
    B, C, T = 3, 2, 1300
    x, b, a, act = k6_case(B, C, T, 1, shared=False)
    act = act if masked else None
    got = scan.biquad_cascade(torch.from_numpy(x), torch.from_numpy(b),
                              torch.from_numpy(a),
                              active=None if act is None
                              else torch.from_numpy(act)).numpy()
    want = np.asarray(biquad_cascade_pallas(
        jnp.asarray(x), jnp.asarray(b), jnp.asarray(a), t_block=512,
        interpret=True, active=None if act is None else jnp.asarray(act)))
    assert got.shape == want.shape == (B, C, T)
    lanes = (x.reshape(B * C, T), np.repeat(b[:, 0], C, axis=0),
             np.repeat(a[:, 0], C, axis=0),
             None if act is None else np.repeat(act[:, 0], C))
    np.testing.assert_array_equal(got.reshape(B * C, T),
                                  k6_numpy(*lanes, np.float32))
    assert_matches_jax(got.reshape(B * C, T), want.reshape(B * C, T),
                       k6_numpy(*lanes, np.float64))


def test_k6_shared_input_equals_its_broadcast():
    """The shared (C, T) mode reads x[c] for lane b*C + c: the same result
    as the broadcast (B, C, T) input, bit for bit."""
    B, C, T = 4, 2, 300
    x, b, a, act = k6_case(B, C, T, 2, shared=True)
    args = (torch.from_numpy(b), torch.from_numpy(a))
    got = scan.biquad_cascade(torch.from_numpy(x), *args,
                              active=torch.from_numpy(act),
                              shared_lead_shape=(B, C))
    want = scan.biquad_cascade(torch.from_numpy(np.broadcast_to(
        x, (B, C, T)).copy()), *args, active=torch.from_numpy(act))
    assert torch.equal(got, want)


def test_k8_plain_matches_pallas_interpret():
    lanes, T = 5, 1300
    c, aa, ar = k8_case(lanes, T, 3)
    got = scan.ballistics(torch.from_numpy(c)[:, None],
                          torch.from_numpy(aa)[:, None],
                          torch.from_numpy(ar)[:, None])
    want = np.asarray(ballistics_pallas(
        jnp.asarray(c)[:, None], jnp.asarray(aa)[:, None],
        jnp.asarray(ar)[:, None], t_block=512, interpret=True))
    assert got.shape == want.shape == (lanes, 1, T)
    got, want = got.numpy()[:, 0], want[:, 0]
    np.testing.assert_array_equal(got, k8_numpy(c, aa, ar, np.float32))
    assert_matches_jax(got, want, k8_numpy(c, aa, ar, np.float64))


@pytest.mark.parametrize("masked", [True, False])
def test_k7_plain_matches_pallas_interpret(masked):
    """T 1300 against t_block 512: the detector state crosses two block
    boundaries; with and without the in-kernel bypass blend."""
    B, C, T = 3, 2, 1300
    x, kw, act = k7_case(B, C, T, 8)
    act = act if masked else None
    got = scan.compressor_fused(
        torch.from_numpy(x), **{k: torch.from_numpy(v) for k, v in kw.items()},
        active=None if act is None else torch.from_numpy(act)).numpy()
    want = np.asarray(compressor_fused_pallas(
        jnp.asarray(x), **{k: jnp.asarray(v) for k, v in kw.items()},
        t_block=512, interpret=True,
        active=None if act is None else jnp.asarray(act)))
    assert got.shape == want.shape == (B, C, T)
    x_in, vec, with_active, _ = scan.compressor_fused_inputs(
        torch.from_numpy(x), **{k: torch.from_numpy(v) for k, v in kw.items()},
        active=None if act is None else torch.from_numpy(act))
    assert with_active == masked and vec.shape == (6 + masked, B * C)
    got = got.reshape(B * C, T)
    np.testing.assert_array_equal(
        got, k7_numpy(x_in.numpy(), vec.numpy(), masked, np.float32))
    assert_matches_jax(got, want.reshape(B * C, T),
                       k7_numpy(x_in.numpy(), vec.numpy(), masked,
                                np.float64))


def test_k11_plain_matches_pallas_interpret():
    a, b = k11_case(5, 1300, 9)
    got = scan.linear_recurrence(torch.from_numpy(a)[:, None],
                                 torch.from_numpy(b)[:, None])
    want = np.asarray(linear_recurrence_pallas(
        jnp.asarray(a)[:, None], jnp.asarray(b)[:, None], t_block=512,
        interpret=True))
    assert got.shape == want.shape == (5, 1, 1300)
    got, want = got.numpy()[:, 0], want[:, 0]
    np.testing.assert_array_equal(got, k11_numpy(a, b, np.float32))
    assert_matches_jax(got, want, k11_numpy(a, b, np.float64))


def test_launch_counts_stay_zero_on_cpu():
    x, b, a, act = k6_case(2, 2, 64, 4, shared=True)
    c, aa, ar = k8_case(2, 64, 5)
    before = dict(scan.launches)
    scan.biquad_cascade(torch.from_numpy(x), torch.from_numpy(b),
                        torch.from_numpy(a), active=torch.from_numpy(act),
                        shared_lead_shape=(2, 2))
    scan.ballistics(torch.from_numpy(c), torch.from_numpy(aa),
                    torch.from_numpy(ar))
    xc, kw, act = k7_case(2, 2, 64, 6)
    scan.compressor_fused(torch.from_numpy(xc), **kw,
                          active=torch.from_numpy(act))
    scan.linear_recurrence(*map(torch.from_numpy, k11_case(2, 64, 7)))
    assert scan.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False])
def test_k6_kernel_matches_plain_on_card(cuda_device, shared):
    # 74 lanes: three 32-lane blocks, the last one ragged; T 2000 in 8
    # chunks of 256 (the last ragged). K6 is a chunked scan: the first
    # chunk bitwise, then the two rules of chunked.gate_excess, (a) on every
    # lane where the float32 plain run lies within 1e-4 x peak of float64
    B, C, T = 37, 2, 2000
    x, b, a, act = k6_case(B, C, T, 6, shared)
    lead = (B, C) if shared else None
    args = scan.biquad_cascade_inputs(
        torch.from_numpy(x), torch.from_numpy(b), torch.from_numpy(a),
        active=torch.from_numpy(act), shared_lead_shape=lead)[:5]
    want32 = scan.biquad_cascade_plain(*args)
    want64 = scan.biquad_cascade_plain(*args, dtype=torch.float64)
    before = scan.launches["biquad_cascade"]
    got = scan.biquad_cascade(*(torch.from_numpy(v).to(cuda_device)
                                for v in (x, b, a)),
                              active=torch.from_numpy(act).to(cuda_device),
                              shared_lead_shape=lead)
    torch.cuda.synchronize()
    assert scan.launches["biquad_cascade"] == before + 1
    got = got.cpu().reshape(want32.shape)
    L = scan.cascade_chunk_len(B * C, T)
    assert torch.equal(got[:, :L], want32[:, :L])
    excess = chunked.gate_excess(got, want32, want64=want64)
    assert excess["b"] <= 0.0 and excess["a_miss_plain_near"] == 0, excess


def _hold_chunked(got, want32, want64, T):
    """K7's and K8's rules on the card: the first chunk bitwise, then (a)
    and (b) of ``chunked.gate_excess``."""
    L = scan.detector_chunk_len(got.shape[0], T)
    assert torch.equal(got[:, :L], want32[:, :L])
    excess = chunked.gate_excess(got, want32, want64=want64)
    assert excess["a"] <= 0.0 and excess["b"] <= 0.0, excess


@pytest.mark.cuda
def test_k8_kernel_matches_plain_on_card(cuda_device):
    # 37 lanes: two 32-lane blocks, the last ragged; T 2000 in 8 chunks of
    # 256 (the last ragged), T 200 in one
    for T in (2000, 200):
        c, aa, ar = k8_case(37, T, 7)
        args = scan.ballistics_inputs(*(torch.from_numpy(v).to(cuda_device)
                                        for v in (c, aa, ar)))[:2]
        want32 = scan.ballistics_plain(*args)
        want64 = scan.ballistics_plain(*args, dtype=torch.float64)
        before = scan.launches["ballistics"]
        got = scan.ballistics(*(torch.from_numpy(v).to(cuda_device)
                                for v in (c, aa, ar)))
        torch.cuda.synchronize()
        assert scan.launches["ballistics"] == before + 1
        _hold_chunked(got, want32, want64, T)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [True, False])
def test_k7_kernel_matches_plain_on_card(cuda_device, masked):
    # 74 lanes: three 32-lane blocks, the last one ragged; T 2000 in 8
    # chunks (the last ragged) with a silent stretch from T/3, T 200 in one
    for T in (2000, 200):
        x, kw, act = k7_case(37, 2, T, 10)

        def inputs(dev):
            return (torch.from_numpy(x).to(dev),
                    {k: torch.from_numpy(v).to(dev) for k, v in kw.items()},
                    torch.from_numpy(act).to(dev) if masked else None)

        xd, kwd, actd = inputs(cuda_device)
        args = scan.compressor_fused_inputs(xd, **kwd, active=actd)[:3]
        want32 = scan.compressor_fused_plain(*args)
        want64 = scan.compressor_fused_plain(*args, dtype=torch.float64)
        before = scan.launches["compressor_fused"]
        got = scan.compressor_fused(xd, **kwd, active=actd)
        torch.cuda.synchronize()
        assert scan.launches["compressor_fused"] == before + 1
        _hold_chunked(got.reshape(want32.shape), want32, want64, T)


@pytest.mark.cuda
def test_k11_kernel_matches_plain_on_card(cuda_device):
    # 37 lanes: two 32-lane blocks, the last ragged; T 2000 in 8 chunks of
    # 256 (the last ragged), T 200 in one, and a long memory at T 20011 in
    # 79 chunks. K11 is a chunked scan: the first chunk bitwise, then the
    # two rules of chunked.gate_excess, (a) on every lane where the float32
    # plain run lies within 1e-4 x peak of float64
    for case in (k11_case(37, 2000, 11), k11_case(37, 200, 11),
                 k11_long_case(37, 20011, 11)):
        a, b = (torch.from_numpy(v) for v in case)
        T = a.shape[1]
        want32 = scan.linear_recurrence_plain(a, b)
        want64 = scan.linear_recurrence_plain(a, b, dtype=torch.float64)
        before = scan.launches["linear_recurrence"]
        got = scan.linear_recurrence(a.to(cuda_device), b.to(cuda_device))
        torch.cuda.synchronize()
        assert scan.launches["linear_recurrence"] == before + 1
        got = got.cpu()
        L = scan.linrec_chunk_len(37, T)
        assert torch.equal(got[:, :L], want32[:, :L])
        excess = chunked.gate_excess(got, want32, want64=want64)
        assert excess["b"] <= 0.0 and excess["a_miss_plain_near"] == 0, excess


@pytest.mark.cuda
def test_k11_rules_reject_a_carry_without_the_chunk_products_on_card(
        cuda_device):
    # on a long memory the carry's term P_k y_k is most of each chunk's
    # start: with the table's P_k row zeroed after pass A, the carry and
    # pass D give an output that the rules reject on every lane
    a, b = (torch.from_numpy(v) for v in k11_long_case(37, 20011, 12))
    want32 = scan.linear_recurrence_plain(a, b)
    want64 = scan.linear_recurrence_plain(a, b, dtype=torch.float64)
    a_d, b_d = a.to(cuda_device), b.to(cuda_device)
    L, table = scan.linrec_table(37, 20011, cuda_device)
    out = torch.empty_like(a_d)
    scan.linear_recurrence_launch(a_d, b_d, out, table, L, 0)
    table[:, 1, :] = 0.0  # row 1: P_k (csrc/scan.cu RecurrenceTable::kP)
    scan.linear_recurrence_launch(a_d, b_d, out, table, L, 1)
    scan.linear_recurrence_launch(a_d, b_d, out, table, L, 2)
    excess = chunked.gate_excess(out.cpu(), want32, want64=want64)
    assert excess["b"] > 0.0 and excess["a_miss_plain_near"] == 37, excess
