"""The plain versions' serial loops (K1's two, K6's, K8's and K11's) run
their time steps in numpy on the CPU and in torch on the card
(``ops/kernels/chunked.py``); ``chip_smoke.py`` holds every scan kernel
against the torch branch. Here the torch branch runs on the CPU
(``chunked.on_host`` forced to False) and is held equal, bit for bit (NaN
equal to NaN), to the numpy branch, in float32 and float64, on random
stable inputs and on inputs whose recurrences grow past float32's range."""

import numpy as np
import pytest
import torch

from st_ito_torch.ops.kernels import chunked, eqcomp, scan

LANES, T, S = 6, 300, 3


def coefficients(rng, unstable):
    """(5S, LANES) biquad rows b0, b1, b2, a1, a2 per section: poles inside
    the unit circle, or (unstable) a first section with poles at 1 and 2."""
    rows = []
    for s in range(S):
        r = rng.uniform(0.3, 0.95, LANES)
        th = rng.uniform(0.05, 3.0, LANES)
        a1, a2 = -2 * r * np.cos(th), r * r
        if unstable and s == 0:
            a1, a2 = np.full(LANES, -3.0), np.full(LANES, 2.0)
        rows += [rng.uniform(-1, 1, LANES), rng.uniform(-1, 1, LANES),
                 rng.uniform(-1, 1, LANES), a1, a2]
    return rows


def k1_args(rng, unstable):
    tail = [rng.uniform(0, 1, LANES).round(),         # eq active
            rng.uniform(-40, 0, LANES),               # threshold dB
            rng.uniform(-0.9, 0, LANES),              # 1/ratio - 1
            rng.uniform(1e-3, 12, LANES),             # knee dB
            rng.uniform(0.5, 0.999, LANES),           # attack alpha
            rng.uniform(0.5, 0.9999, LANES),          # release alpha
            rng.uniform(0.5, 2, LANES),               # makeup
            rng.uniform(0, 1, LANES).round(),         # comp active
            rng.uniform(1, 10, LANES),                # drive
            rng.uniform(0.5, 2, LANES),               # dist gain
            rng.uniform(0, 1, LANES).round()]         # dist active
    if unstable:  # the EQ's growth reaches the output
        tail[0], tail[7], tail[10] = np.ones(LANES), *np.zeros((2, LANES))
    vec = np.stack(coefficients(rng, unstable) + tail)
    x = rng.standard_normal((LANES, T))
    return (x, vec), dict(num_sections=S, with_dist=True, shared_channels=0)


def k6_args(rng, unstable):
    vec = np.stack(coefficients(rng, unstable)
                   + [rng.uniform(0, 1, LANES).round()])
    x = rng.standard_normal((2, T))
    return (x, vec), dict(num_sections=S, with_active=True,
                          shared_channels=2)


def k8_args(rng, unstable):
    c = rng.uniform(-60, 0, (LANES, T))
    if unstable:
        c[:, T // 2:] = -np.inf                       # a detector at -inf
    vec = np.stack([rng.uniform(0.5, 0.999, LANES),
                    rng.uniform(0.5, 0.9999, LANES)])
    return (c, vec), {}


def k11_args(rng, unstable):
    a = rng.uniform(-1, 1, (LANES, T)) * (1.5 if unstable else 0.99)
    if unstable:
        a[:, :] = np.where(np.abs(a) < 1, np.sign(a) + a, a)
    return (a, rng.standard_normal((LANES, T))), {}


CASES = {"k1": (eqcomp.eqcomp_plain, k1_args),
         "k6": (scan.biquad_cascade_plain, k6_args),
         "k8": (scan.ballistics_plain, k8_args),
         "k11": (scan.linear_recurrence_plain, k11_args)}


@pytest.mark.parametrize("unstable", [False, True],
                         ids=["stable", "unstable"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kernel", sorted(CASES))
def test_torch_branch_equals_numpy_branch(kernel, dtype, unstable,
                                          monkeypatch):
    fn, make = CASES[kernel]
    rng = np.random.default_rng(sorted(CASES).index(kernel) + 10 * unstable)
    arrays, kw = make(rng, unstable)
    args = [torch.from_numpy(np.ascontiguousarray(a, np.float32))
            for a in arrays]
    want = fn(*args, **kw, dtype=dtype)
    with monkeypatch.context() as m:
        m.setattr(chunked, "on_host", lambda t: False)
        got = fn(*args, **kw, dtype=dtype)
    assert got.dtype == want.dtype == dtype and got.shape == (LANES, T)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    finite = torch.isfinite(want)
    assert finite.any()
    if unstable:
        assert not finite.all() or want.abs().max() > 1e30
