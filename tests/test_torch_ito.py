"""The port's ITO surface against st_ito_tpu's on the same inputs, the JAX
side on its TPU plan in interpret mode, float32 (``force_jax_tpu_plan``):
``run_es`` at ``gens_per_dispatch=1`` (the host CMA-ES: populations bit for
bit, fitness within 1e-4), the fitness with a content model (1e-4), the
chunked long-audio embed (cosine > 1 - 1e-3), ``run_es_multitrack``
(1e-4), ``run_input`` and ``run_random`` (5e-5) and ``run_rule_based``
(the same hill-climb steps, 1e-4 x peak)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from st_ito_tpu.chain import ChainSpec as JaxChainSpec
from st_ito_tpu.chain import basic_chain as jax_basic_chain
from st_ito_tpu.chain import basic_delay as jax_basic_delay
from st_ito_tpu.chain import basic_reverb as jax_basic_reverb
from st_ito_tpu.ito import engine as jax_engine
from st_ito_tpu.ito.cmaes import CMAES as JaxCMAES
from st_ito_tpu.models.cnn14 import Cnn14Config as JaxCnn14Config
from st_ito_tpu.models.registry import ParamModel as JaxParamModel
from st_ito_tpu.models.registry import get_param_embeds as jax_embeds

from st_ito_torch.chain import (ChainSpec, basic_chain, basic_delay,
                                basic_reverb)
from st_ito_torch.ito import (CMAES, engine, make_fitness_fn, run_es,
                              run_es_multitrack, run_input, run_random,
                              run_rule_based)
from st_ito_torch.models import get_param_embeds

from tests.test_torch_cnn14 import SMALL, jax_params, port_model
from tests.test_torch_es import SEED, SR, T, _audio
from tests.test_torch_render import force_jax_tpu_plan
from tests.torch_jax_cache import shared_compile_cache  # noqa: F401

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    params = jax_params(3, random_bn=False)
    jmodel = JaxParamModel(params=params, config=JaxCnn14Config(**SMALL),
                           embed_dim=32)
    return jmodel, port_model(params)


def _record_asks(monkeypatch, cls, out):
    real = cls.ask

    def ask(self):
        W = real(self)
        out.append(W.copy())
        return W

    monkeypatch.setattr(cls, "ask", ask)


def test_host_cmaes_generations_match_jax(models, monkeypatch):
    """At gens_per_dispatch=1, the CLI's default, the JAX package runs its
    host CMA-ES (st_ito_tpu/ito/engine.py:614,643-680): the port does too,
    so the same seed asks for the same populations, bit for bit (device
    blocks of one drew others from the first generation on), and the
    best-so-far fitness stays within 1e-4 of JAX's."""
    jmodel, model = models
    x, y = _audio(0), _audio(1, styled=True)
    asks = {"jax": [], "port": []}
    _record_asks(monkeypatch, JaxCMAES, asks["jax"])
    _record_asks(monkeypatch, CMAES, asks["port"])
    common = dict(max_iters=2, popsize=8, find_w0=False, sigma0=0.3,
                  seed=SEED, verbose=False, gens_per_dispatch=1)
    with pytest.MonkeyPatch.context() as mp:
        force_jax_tpu_plan(mp)
        want = jax_engine.run_es(jnp.asarray(x), jnp.asarray(y), SR,
                                 jax_basic_chain(), jmodel,
                                 fitness_dtype="float32", fft_mode="mx",
                                 **common)
    got = run_es(x, y, SR, basic_chain(), model, device="cpu", **common)
    assert len(asks["port"]) == len(asks["jax"]) == 2
    for a, b in zip(asks["port"], asks["jax"]):
        np.testing.assert_array_equal(a, b)
    hist = np.asarray(got["fval_history"])
    assert hist.shape == (2,)
    assert np.abs(hist - np.asarray(want["fval_history"])).max() <= 1e-4
    np.testing.assert_array_equal(got["wopt"], want["wopt"])
    assert got["total_evals"] == want["total_evals"] == 16


def test_content_model_fitness_matches_jax(models):
    """A content model's distances join the style distances at twice their
    weight (st_ito_tpu/ito/engine.py:260-265); within 1e-4 of JAX's. The
    delay -> reverb chain: the content term does not depend on the chain,
    and it renders fastest."""
    jmodel, model = models
    cparams = jax_params(5, random_bn=False)
    jcontent = JaxParamModel(params=cparams, config=JaxCnn14Config(**SMALL),
                             embed_dim=32)
    content = port_model(cparams)
    x, y = _audio(0), _audio(1, styled=True)
    chain = ChainSpec((basic_delay(), basic_reverb()))
    W = np.random.default_rng(4).random((4, chain.num_params))
    with pytest.MonkeyPatch.context() as mp:
        force_jax_tpu_plan(mp)
        yj = jnp.asarray(y)
        fit = jax_engine.make_fitness_fn(
            JaxChainSpec((jax_basic_delay(), jax_basic_reverb())), jmodel,
            SR, 2, content_model=jcontent, content_embed_func=jax_embeds,
            compute_dtype="float32", fft_mode="mx")
        want = np.asarray(fit(jnp.asarray(W, jnp.float32), jnp.asarray(x[0]),
                              jax_embeds(yj, jmodel, SR),
                              jax_embeds(yj, jcontent, SR),
                              jax.random.PRNGKey(0)))
    yt = torch.from_numpy(y)
    fit = make_fitness_fn(chain, model, SR, 2, content_model=content,
                          content_embed_func=get_param_embeds, device="cpu")
    got = fit(W, x[0], get_param_embeds(yt, model, SR),
              get_param_embeds(yt, content, SR)).numpy()
    assert np.abs(got - want).max() <= 1e-4, (got, want)
    style_only = make_fitness_fn(chain, model, SR, 2, device="cpu")(
        W, x[0], get_param_embeds(yt, model, SR)).numpy()
    assert np.abs(got - style_only).max() > 1e-3  # the content term counts


def test_chunked_embed_matches_jax(models):
    """_chunked_embed_for: chunks of 8192 every 4096 samples (the tail
    left out), embedded as one batch, averaged and normalised again;
    cosine > 1 - 1e-3 against JAX's; one wrapper per (base, chunk, hop)."""
    jmodel, model = models
    x = np.concatenate([_audio(5), _audio(6, T=2 * T + 1000)[..., :T + 5000]
                        * 0.5], axis=-1)
    x = np.concatenate([x, x[..., ::-1]], axis=0)  # (2, 2, 2 T + 5000)
    got = engine._chunked_embed_for(get_param_embeds, T, T // 2)(
        torch.from_numpy(np.ascontiguousarray(x)), model, SR)
    want = jax_engine._chunked_embed_for(jax_embeds, T, T // 2)(
        jnp.asarray(x), jmodel, SR)
    for k in ("mid", "side"):
        g, w = got[k].numpy().astype(np.float64), np.asarray(want[k])
        cos = np.sum(g * w, -1) / (np.linalg.norm(g, axis=-1)
                                   * np.linalg.norm(w, axis=-1))
        assert cos.min() > 1 - 1e-3, (k, cos)
    assert (engine._chunked_embed_for(get_param_embeds, T, T // 2)
            is engine._chunked_embed_for(get_param_embeds, T, T // 2))


def test_get_param_embeds_chunked_matches_jax(models):
    """registry.get_param_embeds_chunked (st_ito_tpu/models/registry.py:191):
    chunks every ``hop`` samples, cosine > 1 - 1e-3 against JAX's; at T <=
    chunk_len the plain embed."""
    from st_ito_tpu.models.registry import (
        get_param_embeds_chunked as jax_chunked)
    from st_ito_torch.models import get_param_embeds_chunked

    jmodel, model = models
    x = np.concatenate([_audio(13), _audio(14)[..., ::-1]], axis=-1)
    x = np.ascontiguousarray(x)  # (1, 2, 2 T)
    for hop in (None, T // 2):
        got = get_param_embeds_chunked(torch.from_numpy(x), model, SR,
                                       chunk_len=T, hop=hop)
        want = jax_chunked(jnp.asarray(x), jmodel, SR, chunk_len=T, hop=hop)
        for k in ("mid", "side"):
            g, w = got[k].numpy().astype(np.float64), np.asarray(want[k])
            assert float(np.sum(g * w)) > 1 - 1e-3, (hop, k)
    short = get_param_embeds_chunked(torch.from_numpy(x), model, SR,
                                     chunk_len=2 * T)
    plain = get_param_embeds(torch.from_numpy(x), model, SR)
    assert all(torch.equal(short[k], plain[k]) for k in plain)


def test_ito_exports_the_jax_list_but_one():
    """st_ito_torch.ito exports the JAX package's list, run_learned_inference
    included since training was ported (the one name it once lacked)."""
    import st_ito_tpu.ito as jax_ito
    import st_ito_torch.ito as ito

    assert set(ito.__all__) == set(jax_ito.__all__)
    assert all(callable(getattr(ito, name)) for name in ito.__all__)


def test_run_es_multitrack_matches_jax(models, monkeypatch):
    """One host CMA-ES per track (seed + t), every generation of every track
    in one call of the population renderer on per-candidate input: the
    same populations as JAX's, fitness within 1e-4, the final batched
    render within 5e-5."""
    jmodel, model = models
    x = np.concatenate([_audio(7), _audio(8)])
    y = np.concatenate([_audio(9, styled=True), _audio(10, styled=True)])
    asks = {"jax": [], "port": []}
    _record_asks(monkeypatch, JaxCMAES, asks["jax"])
    _record_asks(monkeypatch, CMAES, asks["port"])
    common = dict(max_iters=2, popsize=4, sigma0=0.3, seed=SEED)
    with pytest.MonkeyPatch.context() as mp:
        force_jax_tpu_plan(mp)
        want = jax_engine.run_es_multitrack(
            jnp.asarray(x), jnp.asarray(y), SR, jax_basic_chain(), jmodel,
            fitness_dtype="float32", **common)
    got = run_es_multitrack(x, y, SR, basic_chain(), model, device="cpu",
                            **common)
    assert len(asks["port"]) == 4
    for a, b in zip(asks["port"], asks["jax"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(np.asarray(got["fval_history"]),
                               np.asarray(want["fval_history"]), atol=1e-4)
    out = got["output_audio"]
    assert out.shape == (2, 2, T) and torch.isfinite(out).all()
    assert np.abs(out.numpy() - np.asarray(want["output_audio"])).max() \
        <= 5e-5
    assert got["total_evals"] == 16 and len(got["params"]) == 2


def test_run_input_and_run_random_match_jax():
    x = _audio(11, T=4096)
    assert run_input(x, x, SR)["output_audio"] is x
    got = run_random(x, x, SR, basic_chain(), seed=3, device="cpu")
    want = jax_engine.run_random(jnp.asarray(x), jnp.asarray(x), SR,
                                 jax_basic_chain(), seed=3)
    assert got["param_dict"] == want["param_dict"]
    out = got["output_audio"]
    assert out.shape == (1, 2, 4096)
    assert np.abs(out.numpy() - np.asarray(want["output_audio"])).max() \
        <= 5e-5


def test_run_rule_based_matches_jax(monkeypatch):
    """The matched-EQ FIR (scipy, on the host) and the LUFS hill climb of
    the linked compressor: the same number of climb steps as JAX's, the
    output within 1e-4 x its peak."""
    rng = np.random.default_rng(12)
    t = np.arange(SR) / SR
    x = (np.sin(2 * np.pi * 220 * t) * (0.2 + 0.8 * (t % 0.25 < 0.05))
         + 0.02 * rng.standard_normal((2, SR))).astype(np.float32)[None]
    y = (np.tanh(4 * x[0]) + 0.05 * rng.standard_normal((2, SR))).astype(
        np.float32)[None]
    steps = {"jax": 0, "port": 0}

    def counted(module, key):
        real = module._rb_comp_step

        def step(*a, **k):
            steps[key] += 1
            return real(*a, **k)

        monkeypatch.setattr(module, "_rb_comp_step", step)

    counted(jax_engine, "jax")
    counted(engine, "port")
    want = np.asarray(jax_engine.run_rule_based(jnp.asarray(x),
                                                jnp.asarray(y), SR)
                      ["output_audio"])
    got = run_rule_based(x, y, SR, device="cpu")["output_audio"].numpy()
    assert steps["port"] == steps["jax"] > 0
    assert got.shape == want.shape == (1, 2, SR)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
