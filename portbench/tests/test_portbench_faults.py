"""Runs of the harness on the CPU at a tiny size with the timed path
broken underneath: each fault the cell can have must turn ``correct``
false. (The card's own look is skipped: these drive the rest of a run.)

ITO cells: an answer altered where it is made (every fitness value, the
population renderer's K1 output, or the output audio); a search whose
step leaves its state unchanged; half of each population left out, its
fitness the mean over the rest. Training cells: a step that leaves its
state unchanged, half the batch left out of the step, the loss altered
where it is made. One chip holds no exchange between chips."""

import time

import numpy as np
import pytest
import torch

from conftest import SMALL_ITO, SMALL_TRAIN
from portbench.core import bench

CPU = torch.device("cpu")


def correct(cell, overrides, seconds=0.5):
    ctx = bench.make_context(cell, 2 ** 31 + 17, seconds, False, CPU,
                             overrides=overrides)
    line, checks = bench.run_cell(ctx, time.perf_counter())
    return line["correct"], checks


def test_sound_runs_are_correct():
    assert correct("ito-basic-p512", SMALL_ITO)[0]
    assert correct("pretext-b32", SMALL_TRAIN, 1.0)[0]


def test_ito_fitness_altered(monkeypatch):
    from st_ito_torch.ito import engine

    real = engine.make_fitness_fn

    def shifted(*a, **k):
        fit = real(*a, **k)
        return lambda *b, **c: fit(*b, **c) + 0.1

    monkeypatch.setattr(engine, "make_fitness_fn", shifted)
    ok, checks = correct("ito-basic-p512", SMALL_ITO)
    assert not ok and checks["fitness_gap"][0] > checks["fitness_gap"][1]


def test_ito_render_altered(monkeypatch):
    from st_ito_torch.chain import responses

    real = responses.eq_compressor_fused

    def louder(*a, **k):
        return real(*a, **k) * 1.001

    monkeypatch.setattr(responses, "eq_compressor_fused", louder)
    ok, checks = correct("ito-basic-p512", SMALL_ITO)
    assert not ok and checks["render_gap"][0] > checks["render_gap"][1]


def test_ito_search_state_unchanged(monkeypatch):
    from st_ito_torch.ito import cmaes

    def tell(self, X, fvals):
        # the best so far kept, the search distribution left as it was
        fvals = np.asarray(fvals, np.float64)
        self.counteval += len(fvals)
        self.generation += 1
        i = int(np.argmin(fvals))
        if fvals[i] < self.best_f:
            self.best_f, self.best_x = float(fvals[i]), np.array(X[i])

    monkeypatch.setattr(cmaes.CMAES, "tell", tell)
    ok, checks = correct("ito-basic-p512", SMALL_ITO)
    assert not ok and checks["fitness_gap"][0] > checks["fitness_gap"][1]


def test_ito_half_population_left_out(monkeypatch):
    from st_ito_torch.ito import engine

    real = engine.make_fitness_fn

    def half(*a, **k):
        fit = real(*a, **k)

        def scored(W, *b, **c):
            n = W.shape[0] // 2
            f = fit(W[:n], *b, **c)
            return torch.cat([f, f.mean().expand(W.shape[0] - n)])

        return scored

    monkeypatch.setattr(engine, "make_fitness_fn", half)
    ok, _ = correct("ito-basic-p512", SMALL_ITO)
    assert not ok


def test_ito_output_altered(monkeypatch):
    from st_ito_torch.ito import engine

    real = engine.build_render_fn

    def louder(*a, **k):
        render = real(*a, **k)
        return lambda *b: render(*b) * 1.01

    monkeypatch.setattr(engine, "build_render_fn", louder)
    ok, checks = correct("ito-basic-p512", SMALL_ITO)
    assert not ok and checks["output_gap"][0] > checks["output_gap"][1]


def test_train_state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)
    ok, checks = correct("pretext-b32", SMALL_TRAIN, 1.0)
    assert not ok and checks["change_gap"][0] == pytest.approx(1.0)


def test_train_half_batch_left_out(monkeypatch):
    from st_ito_torch.train import param

    real = param.train_step

    def half(state, batch, generator, cfg, mesh=None):
        n = batch["inputs"].shape[0] // 2
        return real(state, {k: v[:n] for k, v in batch.items()}, generator,
                    cfg, mesh)

    monkeypatch.setattr(param, "train_step", half)
    ok, checks = correct("pretext-b32", SMALL_TRAIN, 1.0)
    assert not ok, checks


def test_train_loss_altered(monkeypatch):
    from st_ito_torch.train import param

    real = param.param_estimator_loss

    def scaled(*a, **k):
        loss, (metrics, feats) = real(*a, **k)
        return loss * 1.001, ({**metrics, "loss": metrics["loss"] * 1.001},
                              feats)

    monkeypatch.setattr(param, "param_estimator_loss", scaled)
    ok, checks = correct("pretext-b32", SMALL_TRAIN, 1.0)
    assert not ok and checks["loss_gap"][0] > checks["loss_gap"][1]
