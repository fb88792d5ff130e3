"""The port's host CMA-ES (``st_ito_torch/ito/cmaes.py``) against
st_ito_tpu's, bit for bit; the snapshot layout both packages share, in the
host form (``CMAES.state_dict``) and the device form
(``device_es.state_to_dict`` / ``state_from_dict``); and ``opt_slice``'s
lift against the JAX package's ``_lift_slice``."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from st_ito_tpu.ito import device_es as jes
from st_ito_tpu.ito.cmaes import CMAES as JaxCMAES
from st_ito_tpu.ito.engine import _lift_slice as jax_lift_slice

from st_ito_torch.ito import CMAES
from st_ito_torch.ito import device_es as tes
from tests.torch_jax_cache import shared_compile_cache  # noqa: F401

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)


def _fvals(X, target=0.3):
    return np.sum((X - target) ** 2, axis=1)


@pytest.mark.parametrize("N,lam,seed", [(36, 8, 7), (19, 16, 0), (5, 12, 3)])
def test_cmaes_is_bitwise_jax(N, lam, seed):
    """Ten generations of ask/tell on the same objective: every population,
    mean, step size, covariance and best bit for bit the JAX package's."""
    x0 = np.random.default_rng(seed).uniform(0.2, 0.8, N)
    port = CMAES(x0, 0.3, popsize=lam, bounds=(0.0, 1.0), seed=seed)
    ref = JaxCMAES(x0, 0.3, popsize=lam, bounds=(0.0, 1.0), seed=seed)
    for _ in range(10):
        X, Xr = port.ask(), ref.ask()
        np.testing.assert_array_equal(X, Xr)
        port.tell(X, _fvals(X))
        ref.tell(Xr, _fvals(Xr))
        for k in ("mean", "C", "B", "D", "pc", "ps", "best_x"):
            np.testing.assert_array_equal(getattr(port, k), getattr(ref, k),
                                          err_msg=k)
        assert (port.sigma, port.best_f) == (ref.sigma, ref.best_f)
    assert port.result[1] == ref.result[1]


def test_cmaes_bounds_and_convergence():
    es = CMAES(np.full(4, 0.5), 0.8, popsize=12, bounds=(0, 1), seed=2)
    for _ in range(60):
        X = es.ask()
        assert X.min() >= 0.0 and X.max() <= 1.0
        es.tell(X, _fvals(X))
    assert es.result[1] < 1e-6
    np.testing.assert_allclose(es.result[0], 0.3, atol=1e-3)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cmaes_state_round_trip_across_packages(writer):
    """A snapshot of either package's CMAES, saved and loaded as run_es
    does (np.savez / np.load), restores the other's state: the next asks,
    from a generator seeded anew, are bit for bit those of a restored
    instance of the writer's own class."""
    make = {"port": CMAES, "jax": JaxCMAES}
    reader = "jax" if writer == "port" else "port"
    es = make[writer](np.full(6, 0.5), 0.3, popsize=8, seed=3)
    for _ in range(3):
        X = es.ask()
        es.tell(X, _fvals(X, 0.2))

    def restored(kind, snap):
        out = make[kind](np.full(6, 0.5), 0.3, popsize=8, seed=3)
        out.load_state_dict(snap)
        return out

    import io

    buf = io.BytesIO()
    np.savez(buf, **es.state_dict())
    buf.seek(0)
    with np.load(buf) as f:
        snap = {k: f[k] for k in f.files}
    a, b = restored(reader, snap), restored(writer, snap)
    assert a.generation == 3 and a.counteval == 24
    assert a.best_f == es.best_f
    np.testing.assert_array_equal(a.mean, es.mean)
    for _ in range(2):
        Xa, Xb = a.ask(), b.ask()
        np.testing.assert_array_equal(Xa, Xb)
        a.tell(Xa, _fvals(Xa))
        b.tell(Xb, _fvals(Xb))


def _jax_device_state(N, lam, steps, seed):
    rng = np.random.default_rng(seed)
    consts = jes.cma_consts(N, lam)
    state = jes.cma_init(rng.uniform(0.3, 0.7, N), 0.25)
    for _ in range(steps):
        X = rng.random((lam, N)).astype(np.float32)
        state = jes.cma_tell(state, consts, jnp.asarray(X),
                             jnp.asarray(_fvals(X), jnp.float32))
    return state


def test_device_snapshot_round_trip_with_jax():
    """The device form: a JAX state's snapshot (state_to_dict) loads into
    the port's state within float32 rounding of the JAX package's own
    state_from_dict (the same float64 eigenbasis, cast once), and the
    port's snapshot of it holds the JAX keys and values."""
    N, lam = 12, 8
    jstate = _jax_device_state(N, lam, 3, 0)
    snap = jes.state_to_dict(jstate)
    want = jes.state_from_dict(snap)
    got = tes.state_from_dict(snap, "cpu")
    for k in ("mean", "sigma", "pc", "ps", "C", "B", "D", "best_x",
              "best_f"):
        w = np.asarray(getattr(want, k))
        np.testing.assert_allclose(getattr(got, k).numpy(), w, rtol=1e-6,
                                   atol=1e-7 * max(1.0, np.abs(w).max()),
                                   err_msg=k)
    assert got.generation == int(want.generation) == 3
    assert got.counteval == int(want.counteval) == 3 * lam
    back = tes.state_to_dict(got)
    assert set(back) == set(snap)
    for k, v in snap.items():
        np.testing.assert_allclose(back[k], v, rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    # the host CMAES takes the device form's snapshot too
    es = CMAES(np.full(N, 0.5), 0.3, popsize=lam)
    es.load_state_dict(back)
    assert es.generation == 3 and es.sigma == back["sigma"]


@pytest.mark.parametrize("s0,s1", [(0, 19), (19, 27), (30, 36)])
def test_lift_slice_matches_jax(s0, s1):
    rng = np.random.default_rng(s0)
    template = rng.random(36).astype(np.float32)
    W = rng.random((8, s1 - s0)).astype(np.float32)
    want = np.asarray(jax_lift_slice(jnp.asarray(template), jnp.asarray(W),
                                     s0))
    got = tes.lift_slice(torch.from_numpy(template), torch.from_numpy(W),
                         s0).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, s0:s1], W)
