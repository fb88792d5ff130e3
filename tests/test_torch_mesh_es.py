"""The ES population over a mesh (axis "pop"): a gloo group of 2 ranks on
the CPU (``torch_mesh_ranks``, one group for the module, started before
the reference runs so that it works beside them) against world size 1 of
the port (the path without a group, which ``parallel.sharded`` leaves
unchanged) and against st_ito_tpu's own runs on
``st_ito_tpu.parallel.make_mesh(2, "pop")`` (the forced host devices of
``tests/conftest.py``). The small Cnn14 of ``test_torch_cnn14`` on the
delay -> reverb chain at T 8192, popsize 8 (4 a rank).

Against world size 1, the JAX mesh tests' limits
(``tests/test_pop_sharding.py``): rtol 1e-6 and atol 1e-7 for the
fitness, the ES histories and ``wopt``; both ranks return the same
result. Against the JAX mesh, the limits the port's own parity tests hold
between the packages (``test_torch_ito``): the fitness and the histories
within 1e-4, the host CMA-ES's populations and ``wopt`` bit for bit. The
random draws differ between the packages, so the port's are handed to
the JAX run: the dropout masks of world size 1 (``torch_train_draws``)
and the device loop's populations (its ``cma_ask`` patched to read world
size 1's asks by generation: the packages' ``eigh`` may pick
eigenvectors of opposite sign, so equal normals need not give equal
populations).
"""

import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_mesh_ranks as ranks  # noqa: E402
from torch_train_draws import record_draws, replay_draws  # noqa: E402

from st_ito_tpu.chain import ChainSpec as JaxChainSpec
from st_ito_tpu.chain import basic_delay as jax_basic_delay
from st_ito_tpu.chain import basic_reverb as jax_basic_reverb
from st_ito_tpu.ito import device_es as jax_device_es
from st_ito_tpu.ito import engine as jax_engine
from st_ito_tpu.ito.cmaes import CMAES as JaxCMAES
from st_ito_tpu.models.cnn14 import Cnn14Config as JaxCnn14Config
from st_ito_tpu.models.registry import ParamModel as JaxParamModel
from st_ito_tpu.models.registry import get_param_embeds as jax_embeds
from st_ito_tpu.parallel import make_mesh as jax_make_mesh

from st_ito_torch.ito import device_es, make_fitness_fn
from st_ito_torch.ito.cmaes import CMAES
from st_ito_torch.models import get_param_embeds

from tests.test_torch_cnn14 import SMALL, jax_params, port_model
from tests.test_torch_es import SR, T, _audio
from tests.torch_jax_cache import shared_compile_cache  # noqa: F401

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-7  # tests/test_pop_sharding.py
PARITY = 1e-4  # the port against JAX (test_torch_ito)
HIST = ("fval_history", "wopt", "wopt_history")


def _inputs():
    params = jax_params(3, random_bn=False)
    chain = ranks.delay_reverb()
    W = np.random.default_rng(4).uniform(0.1, 0.9, (8, chain.num_params))
    return params, {
        "cnn14": SMALL, "cnn14_sd": port_model(params).net.state_dict(),
        "x": torch.from_numpy(_audio(0)),
        "y": torch.from_numpy(_audio(1, styled=True)),
        "xs": torch.from_numpy(np.concatenate([_audio(7), _audio(8)])),
        "ys": torch.from_numpy(np.concatenate([_audio(9), _audio(1)])),
        "W": torch.from_numpy(W.astype(np.float32))}


def _record_asks(monkeypatch, cls, out):
    real = cls.ask

    def ask(self):
        W = real(self)
        out.append(W.copy())
        return W

    monkeypatch.setattr(cls, "ask", ask)


def _jax_runs(params, inputs, folder, device_asks):
    """st_ito_tpu's runs of the cases on its 2-device "pop" mesh, float32,
    the port's draws handed in; the host CMA-ES's asks recorded in both
    packages."""
    jmodel = JaxParamModel(params=params, config=JaxCnn14Config(**SMALL),
                           embed_dim=SMALL["embed_dim"])
    jchain = JaxChainSpec((jax_basic_delay(), jax_basic_reverb()))
    mesh = jax_make_mesh(2, "pop")
    x, y, W = (jnp.asarray(inputs[k].numpy()) for k in ("x", "y", "W"))
    tgt = jax_embeds(y, jmodel, SR)
    key = jax.random.PRNGKey(0)
    out = {}
    fit = jax_engine.make_fitness_fn(jchain, jmodel, SR, 2, mesh=mesh,
                                     compute_dtype="float32")
    out["fitness"] = np.asarray(fit(W, x[0], tgt, None, key))

    model, chain = ranks.param_model(inputs), ranks.delay_reverb()
    g = torch.Generator().manual_seed(11)
    with record_draws(g) as draws:
        make_fitness_fn(chain, model, SR, 2, dropout=0.3, device="cpu")(
            inputs["W"], inputs["x"][0],
            get_param_embeds(inputs["y"], model, SR), None, g)
    with replay_draws(draws):
        fit_d = jax_engine.make_fitness_fn(jchain, jmodel, SR, 2,
                                           dropout=0.3, mesh=mesh,
                                           compute_dtype="float32")
        out["fitness_dropout"] = np.asarray(fit_d(W, x[0], tgt, None, key))

    common = dict(popsize=8, sigma0=0.3, seed=7, verbose=False, mesh=mesh,
                  fitness_dtype="float32")
    asks = {"jax": [], "port": []}
    with pytest.MonkeyPatch.context() as mp:
        _record_asks(mp, JaxCMAES, asks["jax"])
        out["host"] = jax_engine.run_es(x, y, SR, jchain, jmodel,
                                        max_iters=2, find_w0=True, **common)
    out["host_asks"] = asks["jax"]

    # world size 1's populations of the device run (generations 0-3) and
    # of its resume (4-5)
    asked = jnp.asarray(np.stack(device_asks[:6]))

    def ask(state, consts, key):
        return asked[state.generation]

    snap = os.path.join(folder, "jax_device_es.npz")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_device_es, "cma_ask", ask)
        out["device"] = jax_engine.run_es(
            x, y, SR, jchain, jmodel, max_iters=4, find_w0=False,
            gens_per_dispatch=2, es_state_path=snap, **common)
        out["device_resumed"] = jax_engine.run_es(
            x, y, SR, jchain, jmodel, max_iters=2, find_w0=False,
            gens_per_dispatch=2, es_state_path=snap, **common)
    out["multitrack"] = jax_engine.run_es_multitrack(
        jnp.asarray(inputs["xs"].numpy()), jnp.asarray(inputs["ys"].numpy()),
        SR, jchain, jmodel, max_iters=2, popsize=4, seed=3, mesh=mesh,
        fitness_dtype="float32")
    out["staged"] = jax_engine.run_staged_es(
        x, y, SR, jchain, jmodel, max_iters=2, popsize=4, seed=5,
        verbose=False, mesh=mesh, fitness_dtype="float32")
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    folder = tmp_path_factory.mktemp("mesh_es")
    params, inputs = _inputs()
    torch.save(inputs, folder / "inputs.pt")
    group = ranks.start("es", 2, folder)
    try:
        (folder / "ws1").mkdir()
        asks, device_asks = [], []
        real_ask = device_es.cma_ask

        def ask(*a, **k):
            W = real_ask(*a, **k)
            device_asks.append(W.numpy().copy())
            return W

        with pytest.MonkeyPatch.context() as mp:
            _record_asks(mp, CMAES, asks)
            mp.setattr(device_es, "cma_ask", ask)
            ws1 = ranks.es_cases(inputs, None, str(folder / "ws1"))
        want = _jax_runs(params, inputs, str(folder), device_asks)
        ws2 = group.wait()
    finally:
        group.kill()
    return {"ws2": ws2, "ws1": ws1, "jax": want, "asks": asks,
            "folder": folder}


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


def _same_run(got, want):
    for k in HIST:
        _close(got[k], want[k])


def test_ranks_return_the_same_result(runs):
    r0, r1 = runs["ws2"]
    for case in ("fitness", "fitness_dropout", "audio_fitness", "host",
                 "device", "device_resumed", "device_dropout", "savepop",
                 "multitrack", "multitrack_dropout", "staged"):
        a, b = r0[case], r1[case]
        if isinstance(a, dict):
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]),
                                              np.asarray(b[k]), err_msg=k)
        else:
            assert torch.equal(a, b), case


def test_fitness_matches_world_size_1_and_jax(runs):
    got = runs["ws2"][0]["fitness"]
    assert got.shape == (8,)
    _close(got, runs["ws1"]["fitness"])
    _close(got, runs["jax"]["fitness"], rtol=0, atol=PARITY)


def test_dropout_fitness_draws_the_global_masks(runs):
    """Each rank's masks are its rows of world size 1's, and the
    generator advances as world size 1's does (the next draw is the
    same)."""
    got = runs["ws2"][0]
    _close(got["fitness_dropout"], runs["ws1"]["fitness_dropout"])
    assert torch.equal(got["generator_after"],
                       runs["ws1"]["generator_after"])
    assert not torch.allclose(got["fitness_dropout"], got["fitness"])
    _close(got["fitness_dropout"], runs["jax"]["fitness_dropout"], rtol=0,
           atol=PARITY)


def test_return_audio_gathers_to_rank_0(runs):
    r0, r1 = runs["ws2"]
    ws1 = runs["ws1"]
    _close(r0["audio_fitness"], ws1["audio_fitness"])
    _close(r0["audio_mid"], ws1["audio_mid"])
    assert r1["audio"] is None
    assert r0["audio"].shape == (8, 2, T)
    np.testing.assert_array_equal(r0["audio"].numpy(), ws1["audio"].numpy())


def test_indivisible_population_raises(runs):
    msg = runs["ws2"][0]["pop_indivisible"]
    assert msg is not None and "axis of 7 does not split over 2 ranks" in msg
    assert runs["ws1"]["pop_indivisible"] is None


def test_host_loop_matches_world_size_1_and_jax(runs):
    got, want = runs["ws2"][0]["host"], runs["jax"]["host"]
    _same_run(got, runs["ws1"]["host"])
    assert got["total_evals"] == want["total_evals"] == 24
    for a, b in zip(runs["asks"][:2], runs["jax"]["host_asks"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got["wopt"], want["wopt"])
    _close(got["fval_history"], want["fval_history"], rtol=0, atol=PARITY)


def test_device_loop_and_its_resume_match_world_size_1_and_jax(runs):
    """Blocks of 2 generations, a snapshot written by rank 0 alone and read
    by both ranks to resume for 2 more."""
    for case in ("device", "device_resumed"):
        got, want = runs["ws2"][0][case], runs["jax"][case]
        _same_run(got, runs["ws1"][case])
        _close(got["fval_history"], want["fval_history"], rtol=0,
               atol=PARITY)
        _close(got["wopt"], want["wopt"], rtol=0, atol=PARITY)
    assert len(runs["ws2"][0]["device_resumed"]["fval_history"]) == 2
    with np.load(runs["folder"] / "device_es.npz") as snap:
        assert int(snap["generation"]) == 6


def test_device_loop_with_dropout_matches_world_size_1(runs):
    """Dropout's masks and the asks share the generator: its rows drawn
    globally keep every rank's asks equal to world size 1's."""
    _same_run(runs["ws2"][0]["device_dropout"], runs["ws1"]["device_dropout"])


def test_savepop_is_written_once_by_rank_0(runs):
    folder = runs["folder"]
    _same_run(runs["ws2"][0]["savepop"], runs["ws1"]["savepop"])
    for gen in ("pop_-1", "pop_0"):
        got = sorted(os.listdir(folder / "savepop" / gen))
        assert got == sorted(os.listdir(folder / "ws1" / "savepop" / gen))
        assert len(got) == 8


def test_multitrack_matches_world_size_1_and_jax(runs):
    got, want = runs["ws2"][0]["multitrack"], runs["jax"]["multitrack"]
    for k in ("fval_history", "wopt"):
        _close(got[k], runs["ws1"]["multitrack"][k])
    np.testing.assert_array_equal(got["wopt"], want["wopt"])
    _close(got["fval_history"], want["fval_history"], rtol=0, atol=PARITY)
    for k in ("fval_history", "wopt"):
        _close(runs["ws2"][0]["multitrack_dropout"][k],
               runs["ws1"]["multitrack_dropout"][k])


def test_staged_matches_world_size_1_and_jax(runs):
    got, want = runs["ws2"][0]["staged"], runs["jax"]["staged"]
    _same_run(got, runs["ws1"]["staged"])
    np.testing.assert_array_equal(got["wopt"], want["wopt"])
    _close(got["fval_history"], want["fval_history"], rtol=0, atol=PARITY)
    for i in range(2):
        assert (runs["folder"] / f"staged.stage{i}.npz").is_file()
