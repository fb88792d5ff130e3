"""The port's CMA-ES, fitness function and run_es against st_ito_tpu's:
cma_tell on identical populations, cma_ask on injected normals, the
fitness values against the forced-TPU JAX fitness (fft_mode="mx",
float32), a CPU run_es (also in fft_mode="fused"), and run_es's
output_audio against the per-candidate renderers of both packages."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from st_ito_tpu.chain import basic_chain as jax_basic_chain
from st_ito_tpu.chain.executor import build_render_fn as jax_build_render_fn
from st_ito_tpu.ito import device_es as jes
from st_ito_tpu.ito.engine import make_fitness_fn as jax_make_fitness_fn
from st_ito_tpu.models.cnn14 import Cnn14Config as JaxCnn14Config
from st_ito_tpu.models.registry import ParamModel as JaxParamModel
from st_ito_tpu.models.registry import get_param_embeds as jax_embeds

from st_ito_torch.chain import (basic_chain, build_batched_render_fn,
                                build_render_fn)
from st_ito_torch.ito import device_es as tes
from st_ito_torch.ito import make_fitness_fn, run_es
from st_ito_torch.models import Cnn14, Cnn14Config, ParamModel, get_param_embeds
from st_ito_torch.models.cnn14 import init_cnn14_

from tests.test_torch_cnn14 import SMALL, jax_params, port_model
from tests.test_torch_render import force_jax_tpu_plan

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)

SR = 48000
T = 8192
N, LAM = 36, 16
SEED = 7


def _state_pair(rng):
    """The same non-trivial state in both implementations: a random mean,
    paths and an SPD covariance with its eigenbasis."""
    mean = rng.uniform(0.2, 0.8, N)
    A = rng.standard_normal((N, N)) * 0.1
    C = A @ A.T + np.eye(N) * 0.5
    d2, B = np.linalg.eigh(C)
    vals = dict(mean=mean, sigma=0.2, pc=rng.standard_normal(N) * 0.1,
                ps=rng.standard_normal(N) * 0.1, C=C, B=B, D=np.sqrt(d2),
                best_x=mean, best_f=-0.5)
    js = jes.CMAState(**{k: jnp.asarray(v, jnp.float32)
                         for k, v in vals.items()},
                      generation=jnp.asarray(3, jnp.int32),
                      counteval=jnp.asarray(3 * LAM, jnp.int32))
    ts = tes.CMAState(**{k: torch.as_tensor(np.asarray(v, np.float32))
                         for k, v in vals.items()},
                      generation=3, counteval=3 * LAM)
    return js, ts


def test_cma_tell_matches_jax():
    rng = np.random.default_rng(0)
    js, ts = _state_pair(rng)
    jc, tc = jes.cma_consts(N, LAM), tes.cma_consts(N, LAM, "cpu")
    np.testing.assert_allclose(tc.weights.numpy(), np.asarray(jc.weights))
    for step in range(2):
        X = rng.random((LAM, N)).astype(np.float32)
        f = rng.standard_normal(LAM).astype(np.float32)
        if step == 1:
            f[3] = -2.0  # a new best
        js = jes.cma_tell(js, jc, jnp.asarray(X), jnp.asarray(f))
        ts = tes.cma_tell(ts, tc, torch.from_numpy(X), torch.from_numpy(f))
        for k in ("mean", "sigma", "ps", "pc", "C", "best_x", "best_f"):
            np.testing.assert_allclose(getattr(ts, k).numpy(),
                                       np.asarray(getattr(js, k)), atol=1e-5,
                                       err_msg=k)
        assert ts.generation == int(js.generation)
        assert ts.counteval == int(js.counteval)

        def recon(B, D):
            return (B * D[None, :] ** 2) @ B.T

        np.testing.assert_allclose(
            recon(ts.B.numpy(), ts.D.numpy()),
            recon(np.asarray(js.B), np.asarray(js.D)), atol=1e-5)


def test_cma_ask_matches_jax_on_injected_normals(monkeypatch):
    rng = np.random.default_rng(1)
    js, ts = _state_pair(rng)
    z = rng.standard_normal((LAM, N)).astype(np.float32) * 3.0
    monkeypatch.setattr(jes.jax.random, "normal",
                        lambda key, shape, dtype: jnp.asarray(z))
    want = np.asarray(jes.cma_ask(js, jes.cma_consts(N, LAM),
                                  jax.random.PRNGKey(0)))
    got = tes.cma_ask(ts, tes.cma_consts(N, LAM, "cpu"),
                      z=torch.from_numpy(z)).numpy()
    assert got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_cma_ask_draws_from_the_generator():
    _, ts = _state_pair(np.random.default_rng(2))
    consts = tes.cma_consts(N, LAM, "cpu")
    a = tes.cma_ask(ts, consts, torch.Generator().manual_seed(5))
    b = tes.cma_ask(ts, consts, torch.Generator().manual_seed(5))
    assert a.shape == (LAM, N) and torch.equal(a, b)


def _audio(seed, styled=False, T=T):
    """(1, 2, T) float32 program material (a noise floor under enveloped
    partials) with peak exactly 1, so run_es's peak normalisation leaves it
    unchanged; styled: rendered through the basic chain first, so the
    fitness has a landscape (white noise against a random encoder gives
    -1 for every candidate)."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / SR
    a = 0.05 * rng.standard_normal((2, T))
    for f0, amp in ((110.0, 0.3), (220.0, 0.22), (331.0, 0.15),
                    (551.0, 0.1), (1103.0, 0.07)):
        env = 0.5 + 0.5 * np.sin(2 * np.pi * (12.0 * amp + 5.0) * t)
        a += amp * env * np.sin(2 * np.pi * f0 * t + rng.uniform(0, 6.28))
    a = a.astype(np.float32)
    if styled:
        render = build_batched_render_fn(basic_chain(), SR, 2, device="cpu")
        w = torch.from_numpy(rng.random((1, N)).astype(np.float32))
        a = render(w, torch.from_numpy(a))[0].numpy()
    a = a[None]
    return a / np.abs(a).max()


@pytest.fixture(scope="module")
def fitness_case():
    """The JAX fitness, forced onto its TPU plan in float32, of the
    population run_es draws for find_w0 with SEED."""
    params = jax_params(3, random_bn=False)
    x, y = _audio(0), _audio(1, styled=True)
    W = np.random.default_rng(SEED).random((8, N))
    jmodel = JaxParamModel(params=params, config=JaxCnn14Config(**SMALL),
                           embed_dim=32)
    with pytest.MonkeyPatch.context() as mp:
        force_jax_tpu_plan(mp)
        target = jax_embeds(jnp.asarray(y), jmodel, SR)
        fit = jax_make_fitness_fn(jax_basic_chain(), jmodel, SR, 2,
                                  compute_dtype="float32", fft_mode="mx")
        fvals = np.asarray(fit(jnp.asarray(W, jnp.float32),
                               jnp.asarray(x[0]), target, None,
                               jax.random.PRNGKey(0)))
    return params, x, y, W, fvals


def test_fitness_matches_jax_mx_float32(fitness_case):
    params, x, y, W, want = fitness_case
    model = port_model(params)
    target = get_param_embeds(torch.from_numpy(y), model, SR)
    fit = make_fitness_fn(basic_chain(), model, SR, 2, device="cpu")
    got = fit(W, x[0], target).numpy()
    assert np.isfinite(got).all() and got.shape == (8,)
    assert np.abs(got - want).max() <= 1e-4, (got, want)
    assert np.ptp(want) > 0.01  # the case has a landscape
    mb = make_fitness_fn(basic_chain(), model, SR, 2, device="cpu",
                         pop_microbatch=4)(W, x[0], target).numpy()
    np.testing.assert_allclose(mb, got, atol=1e-6)


def test_find_w0_picks_the_jax_row(fitness_case):
    params, x, y, W, fvals = fitness_case
    res = run_es(x, y, SR, basic_chain(), port_model(params), max_iters=0,
                 popsize=8, find_w0=True, seed=SEED, verbose=False,
                 device="cpu")
    np.testing.assert_array_equal(res["wopt"], W[int(np.argmin(fvals))])
    assert res["total_evals"] == 8


def test_run_es_cpu_smoke():
    # the port alone: a small Cnn14 at half SMALL's hop embeds half the audio
    cfg = Cnn14Config(embed_dim=32, window_size=256, hop_size=128,
                      mel_bins=32, base_channels=4)
    model = ParamModel(net=init_cnn14_(Cnn14(cfg),
                                       torch.Generator().manual_seed(4)),
                       config=cfg, embed_dim=32)
    Ts = 4096
    res = run_es(_audio(2, T=Ts), _audio(3, styled=True, T=Ts), SR,
                 basic_chain(), model, max_iters=4, popsize=8,
                 find_w0=False, gens_per_dispatch=2, sigma0=0.3,
                 early_stop_patience=100, verbose=False, device="cpu")
    hist = res["fval_history"]
    assert len(hist) == 4 and np.isfinite(hist).all()
    assert all(b <= a for a, b in zip(hist, hist[1:]))  # best-so-far
    assert res["total_evals"] == 32
    assert res["fopt"] == hist[-1]
    assert res["output_audio"].shape == (1, 2, Ts)
    assert torch.isfinite(res["output_audio"]).all()
    assert set(res["params"]) == {s.name for s in basic_chain().stages}
    assert res["evals_per_sec"] > 0


def test_run_es_cpu_smoke_fused(monkeypatch):
    """fft_mode="fused": the LTI group through K10 -> K9 -> K10 (the plain
    versions here), two K10 calls per generation, on T 8192 (n = 2^14, the
    smallest size fused_fft.supported admits)."""
    from st_ito_torch.ops.kernels import fused_fft

    calls = []
    real = fused_fft.fft_fused_plain
    monkeypatch.setattr(fused_fft, "fft_fused_plain", lambda *a, **k: (
        calls.append(k.get("sign", a[2] if len(a) > 2 else -1)),
        real(*a, **k))[1])
    cfg = Cnn14Config(embed_dim=32, window_size=256, hop_size=128,
                      mel_bins=32, base_channels=4)
    model = ParamModel(net=init_cnn14_(Cnn14(cfg),
                                       torch.Generator().manual_seed(4)),
                       config=cfg, embed_dim=32)
    res = run_es(_audio(2), _audio(3, styled=True), SR, basic_chain(), model,
                 max_iters=2, popsize=4, find_w0=False, gens_per_dispatch=2,
                 sigma0=0.3, early_stop_patience=100, verbose=False,
                 fft_mode="fused", device="cpu")
    hist = res["fval_history"]
    assert len(hist) == 2 and np.isfinite(hist).all()
    assert res["total_evals"] == 8
    assert res["output_audio"].shape == (1, 2, T)
    assert torch.isfinite(res["output_audio"]).all()
    assert calls == [-1, 1] * 2


def test_output_audio_is_the_per_candidate_render():
    """run_es renders output_audio with build_render_fn, as the JAX package
    does (st_ito_tpu/ito/engine.py:628-630): equal to the port's
    build_render_fn(wopt) bit for bit and to the JAX package's within 5e-5
    after peak normalisation (the distortion is bypassed, so no drive
    factor). The population renderer at B = 1, which rendered it before, is
    tail-continuous and differs by far more than that."""
    chain = basic_chain()
    x = _audio(2, T=4096)
    w0 = np.random.default_rng(11).uniform(0.3, 0.7, N)
    starts = [s for _, s, _ in chain.stage_slices()]
    w0[starts] = 0.2
    w0[starts[2]] = 0.8            # distortion off
    w0[starts[3] + 1] = 0.03       # delay 0.0397 s: echoes inside the buffer
    w0[starts[3] + 2] = 0.8        # feedback 0.81: a tail past its end
    cfg = Cnn14Config(embed_dim=32, window_size=256, hop_size=128,
                      mel_bins=32, base_channels=4)
    model = ParamModel(net=init_cnn14_(Cnn14(cfg),
                                       torch.Generator().manual_seed(4)),
                       config=cfg, embed_dim=32)
    res = run_es(x, _audio(3, T=4096), SR, chain, model, max_iters=0,
                 popsize=4, find_w0=False, w0=w0, verbose=False,
                 device="cpu")
    np.testing.assert_array_equal(res["wopt"], w0)
    out = res["output_audio"]
    assert out.shape == (1, 2, 4096)
    w32 = w0.astype(np.float32)
    own = build_render_fn(chain, SR, 2, device="cpu")(w32, x[0])
    assert torch.equal(out[0], own)
    want = np.asarray(jax_build_render_fn(jax_basic_chain(), SR, 2)(
        jnp.asarray(w32), jnp.asarray(x[0])))
    assert np.abs(out[0].numpy() - want).max() <= 5e-5
    batched = build_batched_render_fn(chain, SR, 2, device="cpu")(
        torch.from_numpy(w32[None]), torch.from_numpy(x[0]))[0].numpy()
    assert np.abs(batched - want).max() > 1e-3
