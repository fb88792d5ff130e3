"""The control flow of the port's ``run_es`` modes, most of it with the
fitness replaced by a synthetic objective (as ``tests/test_ito.py`` tests
the JAX package's) and held against the JAX package under the same
objective: the host loop's early stopping, dropout off in the final
generation (host and device loops), ``opt_slice``, ``run_staged_es`` (the
frozen prefix, the stage seeds, the per-stage snapshots), ``es_state_path``
resumed across the packages in the host and the device form; and with a
small real encoder: embedding dropout's masks, ``savepop``'s files, the
chunked long-audio mode over the full T and its automatic sub-batch."""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from st_ito_tpu.chain import ChainSpec as JaxChainSpec
from st_ito_tpu.chain import basic_delay as jax_basic_delay
from st_ito_tpu.chain import basic_parametric_eq as jax_basic_eq
from st_ito_tpu.chain import basic_reverb as jax_basic_reverb
from st_ito_tpu.ito import device_es as jes
from st_ito_tpu.ito import engine as jax_engine
from st_ito_tpu.ito.cmaes import CMAES as JaxCMAES

from st_ito_torch.chain import (ChainSpec, basic_delay, basic_parametric_eq,
                                basic_reverb)
from st_ito_torch.ito import (CMAES, device_es, engine, make_fitness_fn,
                              run_es, run_staged_es)
from st_ito_torch.models import (Cnn14, Cnn14Config, ParamModel,
                                 get_param_embeds, registry)
from st_ito_torch.models.cnn14 import init_cnn14_
from st_ito_torch.utils import load_audio

# the suite runs in several worker processes side by side: one intra-op
# thread each, so that their pools do not oversubscribe the cores
torch.set_num_threads(1)

SR = 48000
T = 4096
P = 28  # the vst chain's parameters: EQ [0, 19), delay [19, 23), reverb


def _vst(jax=False):
    """EQ -> delay -> reverb (the CLI's vst chain), in either package."""
    if jax:
        return JaxChainSpec((jax_basic_eq(), jax_basic_delay(),
                             jax_basic_reverb()))
    return ChainSpec((basic_parametric_eq(), basic_delay(), basic_reverb()))


def _lti():
    """Delay -> reverb: the cheapest chain to render on the CPU."""
    return ChainSpec((basic_delay(), basic_reverb()))


def _signal(seed, T=T):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / SR
    x = (np.sin(2 * np.pi * 330 * t) * (0.3 + 0.7 * (t % 0.02 < 0.005))
         + 0.05 * rng.standard_normal((2, T)))
    return (x / np.abs(x).max()).astype(np.float32)[None]


@pytest.fixture(scope="module")
def model():
    """A small encoder whose 32 frames fit in T = 4096 (hop 128)."""
    cfg = Cnn14Config(embed_dim=32, window_size=256, hop_size=128,
                      mel_bins=32, base_channels=4)
    return ParamModel(net=init_cnn14_(Cnn14(cfg),
                                      torch.Generator().manual_seed(4)),
                      config=cfg, embed_dim=32)


def _objective(W):
    return np.sum((np.asarray(W, np.float64) - 0.3) ** 2, axis=1)


def _patch_fitness(monkeypatch, module, make_fvals=_objective, record=None):
    """Replace ``module.make_fitness_fn`` (the port's engine or the JAX
    package's) with a synthetic objective of the full parameter vectors;
    ``record`` collects (dropout, W) per call."""
    is_port = module is engine

    def fake_make_fitness_fn(*args, **kwargs):
        dropout = args[7] if len(args) > 7 else kwargs.get("dropout", 0.0)

        def fitness(W, x, target_embeds, target_content_embeds=None,
                    rng=None):
            W = np.asarray(W)
            if record is not None:
                record.append((dropout, W.copy()))
            v = make_fvals(W)
            return (torch.as_tensor(v, dtype=torch.float32) if is_port
                    else jnp.asarray(v, jnp.float32))

        return fitness

    monkeypatch.setattr(module, "make_fitness_fn", fake_make_fitness_fn)


def _zero_embed(audio, model, sample_rate, **kwargs):
    return {"mono": (torch.zeros if isinstance(audio, torch.Tensor)
                     else jnp.zeros)((audio.shape[0], 4))}


def _port_run(chain=None, **kw):
    x = _signal(0)
    return run_es(x, x, SR, chain or _vst(), None, embed_func=_zero_embed,
                  find_w0=False, seed=0, verbose=False, device="cpu", **kw)


def _jax_run(**kw):
    x = jnp.asarray(_signal(0))
    return jax_engine.run_es(x, x, SR, _vst(jax=True), None,
                             embed_func=_zero_embed, find_w0=False, seed=0,
                             verbose=False, **kw)


# ---------------------------------------------------------------- host loop


def test_host_loop_improving_run_is_not_truncated(monkeypatch):
    calls = {"n": 0}

    def improving(W):
        calls["n"] += 1
        return np.full(W.shape[0], -0.02 * calls["n"])

    _patch_fitness(monkeypatch, engine, improving)
    res = _port_run(max_iters=20, popsize=8)
    assert len(res["fval_history"]) == len(res["wopt_history"]) == 20


def test_host_loop_stalled_run_stops_early(monkeypatch):
    _patch_fitness(monkeypatch, engine, lambda W: np.ones(W.shape[0]))
    res = _port_run(max_iters=40, popsize=8, early_stop_patience=10)
    # gen 0 seeds the counter; gens 1..11 show no improvement -> stop at 12
    assert len(res["fval_history"]) == 12


@pytest.mark.parametrize("gens_per_dispatch,max_iters,want", [
    (1, 3, [0.5, 0.5, 0.0]),
    (3, 5, [0.5, 0.5, 0.5, 0.5, 0.0]),
])
def test_final_generation_disables_dropout(monkeypatch, gens_per_dispatch,
                                           max_iters, want):
    """Dropout is off in the final generation: the host loop scores it with
    the dropout-free fitness, the device loop runs it as a block of its own
    after max_iters - 1 generations (st_ito_tpu/ito/engine.py:769,811-823;
    tests/test_ito.py:236,353)."""
    record = []
    _patch_fitness(monkeypatch, engine, record=record)
    res = _port_run(max_iters=max_iters, popsize=8, dropout=0.5,
                    gens_per_dispatch=gens_per_dispatch)
    assert [d for d, _ in record] == want
    assert len(res["fval_history"]) == max_iters


def test_host_loop_matches_jax_under_opt_slice(monkeypatch):
    """opt_slice: the slice-wide candidates lifted into the frozen template
    (full vectors reach the fitness), wopt_history full-width; every
    generation bit for bit the JAX package's under the same objective."""
    template = np.random.default_rng(1).random(_vst().num_params)
    got, want = [], []
    _patch_fitness(monkeypatch, engine, record=got)
    _patch_fitness(monkeypatch, jax_engine, record=want)
    kw = dict(max_iters=3, popsize=8, opt_slice=(19, 23),
              w_template=template, w0=np.full(4, 0.6))
    res, ref = _port_run(**kw), _jax_run(**kw)
    assert len(got) == len(want) == 3
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            a[:, np.r_[0:19, 23:a.shape[1]]],
            np.broadcast_to(template.astype(np.float32)[np.r_[0:19, 23:P]],
                            (8, a.shape[1] - 4)))
    assert all(w.shape == (P,) for w in res["wopt_history"])
    np.testing.assert_array_equal(res["wopt"], ref["wopt"])
    np.testing.assert_array_equal(res["fval_history"], ref["fval_history"])


def test_device_loop_lifts_opt_slice(monkeypatch):
    record = []
    _patch_fitness(monkeypatch, engine, record=record)
    template = np.random.default_rng(2).random(_vst().num_params)
    res = _port_run(max_iters=4, popsize=8, gens_per_dispatch=2,
                    opt_slice=(0, 19), w_template=template)
    assert len(record) == 4
    for _, W in record:
        assert W.shape == (8, P)
        np.testing.assert_array_equal(
            W[:, 19:], np.broadcast_to(template[19:].astype(np.float32),
                                       (8, P - 19)))
    assert all(w.shape == (P,) for w in res["wopt_history"])
    np.testing.assert_array_equal(res["wopt"][19:], template[19:])


# ---------------------------------------------------------------- staged ES


def test_run_staged_es_matches_jax(monkeypatch, tmp_path):
    """Stage by stage through run_es with opt_slice: each stage frozen at
    the vector so far, seeded seed + stage, its snapshot in
    {es_state_path}.stage{i}.npz; every population bit for bit the JAX
    package's under the same objective, and the same snapshots."""
    got, want = [], []
    _patch_fitness(monkeypatch, engine, record=got)
    _patch_fitness(monkeypatch, jax_engine, record=want)
    x = _signal(0)
    kw = dict(embed_func=_zero_embed, max_iters=3, popsize=8, seed=5,
              verbose=False)
    res = run_staged_es(x, x, SR, _vst(), None, device="cpu",
                        es_state_path=str(tmp_path / "port"), **kw)
    ref = jax_engine.run_staged_es(jnp.asarray(x), jnp.asarray(x), SR,
                                   _vst(jax=True), None,
                                   es_state_path=str(tmp_path / "jax"), **kw)
    assert len(got) == len(want) == 9
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    init = _vst().init_params().numpy()
    slices = [(s, e) for _, s, e in _vst().stage_slices()]
    for i, (s, e) in enumerate(slices):
        for _, W in got[3 * i:3 * i + 3]:
            np.testing.assert_array_equal(  # later stages at their init
                W[:, e:], np.broadcast_to(init[e:], (8, P - e)))
            if i:  # earlier stages frozen at their optimum
                np.testing.assert_array_equal(
                    W[:, :s], np.broadcast_to(
                        res["wopt_history"][3 * i - 1][:s].astype(
                            np.float32), (8, s)))
        snap, jsnap = (np.load(tmp_path / f"{who}.stage{i}.npz")
                       for who in ("port", "jax"))
        assert int(snap["generation"]) == 3
        for k in jsnap.files:
            np.testing.assert_array_equal(snap[k], jsnap[k], err_msg=k)
    np.testing.assert_array_equal(res["wopt"], ref["wopt"])
    assert len(res["fval_history"]) == len(res["wopt_history"]) == 9
    assert res["output_audio"].shape == (1, 2, T)
    assert res["total_evals"] == 72


def test_run_staged_es_early_stops_per_stage(monkeypatch):
    """Each stage runs the full loop: a stalled stage stops at patience + 2
    generations (tests/test_ito.py:466)."""
    _patch_fitness(monkeypatch, engine, lambda W: np.ones(W.shape[0]))
    x = _signal(0)
    res = run_staged_es(x, x, SR, _vst(), None, embed_func=_zero_embed,
                        max_iters=30, popsize=8, seed=0, verbose=False,
                        early_stop_patience=3, device="cpu")
    assert len(res["fval_history"]) == 5 * 3


def test_run_staged_es_runs_the_real_fitness(model):
    """tests/test_ito.py:446 on the port: a small encoder, the delay ->
    reverb chain, every stage's generations in the histories."""
    x, y = _signal(0), _signal(1)
    res = run_staged_es(x, y, SR, _lti(), model, max_iters=2, popsize=4,
                        sigma0=0.3, seed=0, verbose=False, device="cpu")
    assert res["output_audio"].shape == (1, 2, T)
    assert torch.isfinite(res["output_audio"]).all()
    assert len(res["fval_history"]) == len(res["wopt_history"]) == 4
    assert np.isfinite(res["fopt"]) and res["total_evals"] == 16


# ---------------------------------------------------------------- snapshots


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_host_snapshot_resumes_across_packages(monkeypatch, tmp_path,
                                               writer):
    """es_state_path, host form: a snapshot written by either package's
    run_es resumes in the other's; the next population is bit for bit the
    one the snapshot's own CMAES asks for, and the snapshot goes on."""
    path = str(tmp_path / "es.npz")
    record = []
    _patch_fitness(monkeypatch, engine, record=record)
    _patch_fitness(monkeypatch, jax_engine, record=record)
    kw = dict(popsize=8, sigma0=0.3, es_state_path=path)
    (_jax_run if writer == "jax" else _port_run)(max_iters=2, **kw)
    with np.load(path) as f:
        snap = {k: f[k] for k in f.files}
    assert int(snap["generation"]) == 2
    es = (JaxCMAES if writer == "jax" else CMAES)(np.full(P, 0.5), 0.3,
                                                  popsize=8, seed=0)
    es.load_state_dict(snap)
    record.clear()
    (_port_run if writer == "jax" else _jax_run)(max_iters=1, **kw)
    np.testing.assert_array_equal(record[0][1], es.ask().astype(np.float32))
    with np.load(path) as f:
        assert int(f["generation"]) == 3 and int(f["counteval"]) == 24


def test_device_snapshot_resumes_in_the_port(monkeypatch, tmp_path):
    """es_state_path, device form: a JAX device state's snapshot resumes in
    the port's device loop (its first ask starts from that state, within
    float32 rounding), which then writes its own every block."""
    path = str(tmp_path / "es.npz")
    consts = jes.cma_consts(P, 8)
    state = jes.cma_init(np.full(P, 0.4), 0.2)
    rng = np.random.default_rng(3)
    for _ in range(2):
        X = rng.random((8, P)).astype(np.float32)
        state = jes.cma_tell(state, consts, jnp.asarray(X),
                             jnp.asarray(_objective(X), jnp.float32))
    np.savez(path, **jes.state_to_dict(state))
    seen = []
    real_ask = device_es.cma_ask
    monkeypatch.setattr(device_es, "cma_ask", lambda st, *a, **k: (
        seen.append(st), real_ask(st, *a, **k))[1])
    _patch_fitness(monkeypatch, engine)
    _port_run(max_iters=4, popsize=8, gens_per_dispatch=2,
              es_state_path=path)
    for k in ("mean", "sigma", "C", "ps", "pc", "best_x"):
        np.testing.assert_allclose(getattr(seen[0], k).numpy(),
                                   np.asarray(getattr(state, k)), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    assert seen[0].generation == 2 and len(seen) == 4
    with np.load(path) as f:
        assert int(f["generation"]) == 6 and int(f["counteval"]) == 48


# ------------------------------------------------------ with a real encoder


def test_embedding_dropout_masks(monkeypatch):
    """Each element kept with probability 1 - dropout and scaled by
    1 / (1 - dropout) before the normalisation; the same generator seed
    draws the same masks; no generator, no dropout."""

    class Ones:
        config = Cnn14Config()

        def __call__(self, x):
            return (torch.ones(x.shape[0], 8192),) * 2

    monkeypatch.setattr(registry, "_l2_normalize", lambda e: e)
    x = torch.ones(4, 2, 1024)
    out = get_param_embeds(x, Ones(), SR, dropout=0.25,
                           generator=torch.Generator().manual_seed(0))
    for e in out.values():
        kept = e != 0
        assert abs(float(kept.float().mean()) - 0.75) < 0.01
        assert torch.equal(e[kept], torch.full_like(e[kept], 1 / 0.75))
    assert not torch.equal(out["mid"], out["side"])
    again = get_param_embeds(x, Ones(), SR, dropout=0.25,
                             generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(out[k], again[k]) for k in out)
    plain = get_param_embeds(x, Ones(), SR, dropout=0.25)
    assert torch.equal(plain["mid"], torch.ones(4, 8192))


def test_dropout_fitness_is_repeatable(model):
    """A fixed generator gives a repeatable fitness, another seed another
    one, dropout 0 the fitness without masks; a microbatch is ignored under
    dropout (the masks would repeat across sub-batches)."""
    x, y = _signal(0)[0], _signal(1)
    target = get_param_embeds(torch.from_numpy(y), model, SR)
    W = np.random.default_rng(0).random((4, _lti().num_params))
    fit = make_fitness_fn(_lti(), model, SR, 2, dropout=0.3,
                          pop_microbatch=2, device="cpu")

    def score(seed):
        return fit(W, x, target, None, torch.Generator().manual_seed(seed))

    a, b, c = score(1), score(1), score(2)
    assert torch.equal(a, b) and not torch.allclose(a, c)
    clean = make_fitness_fn(_lti(), model, SR, 2, device="cpu")(W, x, target)
    assert not torch.allclose(a, clean)
    assert torch.isfinite(a).all() and a.shape == (4,)


def test_savepop_writes_ranked_generations(model, tmp_path):
    """savepop: find_w0's generation in pop_-1 and each generation's in
    pop_{i}, one WAV per candidate, named by rank in ascending fitness;
    it runs the host loop whatever gens_per_dispatch asks for."""
    x, y = _signal(0), _signal(1)
    res = run_es(x, y, SR, _lti(), model, max_iters=2, popsize=4,
                 sigma0=0.3, seed=0, verbose=False, savepop=True,
                 run_dir=str(tmp_path), gens_per_dispatch=2, device="cpu")
    assert sorted(os.listdir(tmp_path)) == ["pop_-1", "pop_0", "pop_1"]
    for gen in ("pop_-1", "pop_0", "pop_1"):
        names = os.listdir(tmp_path / gen)
        ranks = sorted(names, key=lambda n: int(n.split("_")[3]))
        assert [int(n.split("_")[3]) for n in ranks] == [0, 1, 2, 3]
        fvals = [float(n[:-4].split("fval_")[1]) for n in ranks]
        assert fvals == sorted(fvals)
        for n in names:
            audio, sr = load_audio(str(tmp_path / gen / n))
            assert sr == SR and audio.shape == (2, T)
            assert np.isfinite(audio).all() and np.abs(audio).max() > 0.99
    assert min(fvals) >= res["fopt"] - 1e-4


def test_chunked_run_es_covers_the_full_input(model, monkeypatch):
    """chunked=True: every candidate rendered on the whole input with the
    tail guard capped at min(T, 10 s), embedded in chunks of crop_len, no
    random crop; the output covers the full T."""
    seen = []
    real = engine.make_fitness_fn

    def spy(*a, **k):
        fit = real(*a, **k)
        seen.append(k["max_lti_pad"])

        def fitness(W, x, *rest):
            seen.append(tuple(x.shape))
            return fit(W, x, *rest)

        return fitness

    monkeypatch.setattr(engine, "make_fitness_fn", spy)
    Tl = 3 * T + 1000
    x, y = _signal(0, Tl), _signal(1, Tl)
    res = run_es(x, y, SR, _lti(), model, max_iters=2, popsize=4,
                 sigma0=0.3, crop_len=T, chunked=True, random_crop=True,
                 find_w0=False, seed=0, verbose=False, device="cpu")
    assert seen == [Tl, (2, Tl), (2, Tl)]
    out = res["output_audio"]
    assert out.shape == (1, 2, Tl) and torch.isfinite(out).all()
    assert len(res["fval_history"]) == 2


def test_long_microbatch_rule(monkeypatch):
    """The automatic sub-batch halves the population while it is even and
    above 8 until its measured bytes fit the share of the free memory, as
    the JAX package's rule does with its own figures
    (st_ito_tpu/ito/engine.py:530-541); None when the whole fits."""
    per = engine.LONG_BYTES_PER_FFT_SAMPLE * 2 ** 22  # next_pow2(T + 10 s)
    dev = torch.device("cpu")
    for free_cands, pop, want in ((200, 128, None), (100, 128, 64),
                                  (40, 128, 32), (1, 128, 8), (0, 12, 6),
                                  (0, 9, None), (0, 8, None)):
        monkeypatch.setattr(engine, "_free_bytes", lambda d, n=free_cands:
                            n * per / engine.LONG_FREE_SHARE)
        assert engine._long_microbatch(pop, 2880000, 480000, dev) == want


def test_chunked_microbatch_equals_the_whole_population(model, monkeypatch):
    """A sub-batched chunked fitness equals the whole population's (atol
    1e-6), and run_es picks the sub-batch itself when the free memory is
    short."""
    x, y = _signal(0, 3 * T), _signal(1, 3 * T)
    embed = engine._chunked_embed_for(get_param_embeds, T)
    target = embed(torch.from_numpy(y), model, SR)
    W = np.random.default_rng(1).random((8, _lti().num_params))
    kw = dict(embed_func=embed, max_lti_pad=3 * T, device="cpu")
    whole = make_fitness_fn(_lti(), model, SR, 2, **kw)(W, x[0], target)
    parts = make_fitness_fn(_lti(), model, SR, 2, pop_microbatch=2,
                            **kw)(W, x[0], target)
    np.testing.assert_allclose(parts.numpy(), whole.numpy(), atol=1e-6)

    picked = []
    real = engine.make_fitness_fn
    monkeypatch.setattr(engine, "make_fitness_fn", lambda *a, **k: (
        picked.append(k["pop_microbatch"]), real(*a, **k))[1])
    monkeypatch.setattr(engine, "_free_bytes", lambda d: 0)
    run_es(x, y, SR, _lti(), model, max_iters=0, popsize=16, crop_len=T,
           chunked=True, verbose=False, device="cpu")
    assert picked == [8]
