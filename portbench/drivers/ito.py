"""ITO jobs: ``st_ito_torch.ito.run_es`` whole, back to back.

Set-up draws the AFx-Rep Cnn14's weights from the seed on the card, sets
every BatchNorm's running statistics to the batch statistics of the
pool's clips (``reference/cnn14.py calibrate_bn``, in float64), loads them
into the port's module (``Cnn14.load_state_dict``, wrapped in
``ParamModel``, the handle ``load_param_model`` returns: no checkpoint is
searched for), makes a pool of (input, target) pairs from the seed, and
warms up with a one-generation job at the cell's shapes. The window starts
jobs until ``seconds`` have passed and finishes the one in progress; job j
takes pair j mod pool and seed ``seed * 1000 + j``.

Every job is handed a ``Probe`` as its ``embed_func``: the program's own
``get_param_embeds``, which also counts the candidates the job embeds and
keeps host copies of what the check reads: each job's target embedding,
the embeddings of its first ``1 + replay_generations`` populations
(find_w0's and the search's first), and the renders of ``probe_rows``
rows of find_w0's population, drawn from the seed. The evaluations
counted are the probe's, and a job whose own ``total_evals`` differs from
them is failed.

The check, after the window with the program freed, by the plain float64
reference (``reference/render.py``, ``reference/cnn14.py``,
``reference/cmaes.py``), on ``probe_jobs`` jobs drawn from the seed:

- find_w0's population is drawn again from the job's seed, and the search
  replayed from it by the reference CMA-ES, told the fitness values that
  the program's embeddings give (the program's own ranking: the reference
  could only follow the search step by step from the program's state, so
  the rows it scores are what a sound search asks for next);
- ``fitness_gap``: the widest gap between a fitness value the program
  made and the reference's fitness of the same vector, over
  ``probe_rows`` rows of each recorded population (a search that leaves
  its state unchanged, or scores half its population, scores other
  vectors than these), and on every job its final (wopt, fopt) and
  ``check_generations`` (wopt_history, fval_history) entries;
- ``render_gap``: the population renderer's output for find_w0's drawn
  rows (its first ``render_chunks`` chunks in the long-audio mode)
  against the reference's ``render_population``: each row's
  root-mean-square gap over the reference's, the median over the rows
  (``render_widest``, the worst row's, is reported beside it: a row with
  a resonant low shelf carries float32's rounding magnified, PERF.md);
- ``embed_gap``: for the same rows, the widest distance between the
  program's embedding (each item's, as it hands them on) and the
  reference's, both of unit length, over mid and side;
- ``output_gap``: each job's ``output_audio`` against the reference's
  ``render_candidate`` of wopt, the widest gap over the reference's peak.

``mode`` puts the reference one precision step below the configuration's
in the program's place, on the same vectors: "control" (every render stage
rounded to bfloat16, every convolution's input and weight to float8
e4m3), "control_render" (the render alone) and "control_embed" (the
convolutions alone). Two further modes read what a faulty search would
score: "fault_unchanged" (the search's state left as it was after the
first generation) and "fault_half" (the second half of each population
given the first half's fitness values)."""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from portbench.core import audio, counters, weights
from portbench.core.bench import HERE
from portbench.reference import cmaes as ref_cmaes
from portbench.reference import cnn14 as ref_cnn14
from portbench.reference import render as ref_render

MODES = ("program", "control", "control_render", "control_embed",
         "fault_unchanged", "fault_half")


def chain_path(traffic) -> str:
    return os.path.join(HERE, "chains", f"{traffic['chain']}.json")


def job_seed(seed: int, j: int) -> int:
    return seed * 1000 + j


def chunks_of(ctx) -> int:
    """Chunks an item is embedded as (1 outside the long-audio mode)."""
    T, crop = ctx["traffic"]["samples"], ctx["config"]["crop_len"]
    if not ctx["traffic"]["chunked"] or T <= crop:
        return 1
    return (T - crop) // crop + 1


def render_rows(ctx, j: int) -> list[int]:
    """The rows of job j's find_w0 population whose renders are kept."""
    pop = ctx["traffic"]["popsize"]
    rng = np.random.default_rng([ctx["seed"], j, 0])
    k = min(ctx["traffic"]["probe_rows"], pop)
    return sorted(rng.choice(pop, size=k, replace=False).tolist())


class Probe:
    """``embed_func`` of every job: ``base`` (the program's embed) itself,
    counting and copying as the module's docstring says."""

    peak_normalizes_input = True

    def __init__(self, base, popsize: int, chunks: int, generations: int,
                 render_chunks: int):
        self.base, self.popsize, self.chunks = base, popsize, chunks
        self.kept_items = popsize * generations
        self.render_chunks = render_chunks
        self.job = None

    def start(self, rows) -> dict:
        self.job = {"target": None, "embeds": [], "renders": {},
                    "items": 0, "rows": set(rows)}
        return self.job

    def __call__(self, x, model, sample_rate, **kwargs):
        out = self.base(x, model, sample_rate, **kwargs)
        job = self.job
        if job is None:
            return out
        items = x.shape[0] // self.chunks
        if items == 1 and job["target"] is None:
            job["target"] = {k: v.to("cpu") for k, v in out.items()}
            return out
        first = job["items"]
        job["items"] += items
        if first < self.kept_items:
            job["embeds"].append({k: v.to("cpu") for k, v in out.items()})
            for i in sorted(job["rows"]):
                if first <= i < first + items:
                    at = (i - first) * self.chunks
                    part = x[at:at + self.render_chunks]
                    job["renders"][i] = torch.cat(list(part), dim=-1).to(
                        "cpu")
        return out


def setup(ctx):
    from st_ito_torch.chain import chain_from_json
    from st_ito_torch.models.cnn14 import Cnn14, Cnn14Config
    from st_ito_torch.models.registry import ParamModel, get_param_embeds

    cfg, traffic, dev = ctx["config"], ctx["traffic"], ctx["device"]
    enc = cfg["encoder"]
    pool = [audio.pair(ctx["seed"], i, cfg["channels"], traffic["samples"],
                       cfg["sample_rate"], dev)
            for i in range(traffic["pool"])]
    params = weights.draw(ctx["seed"], ref_cnn14.param_specs(enc), dev)
    clips = torch.cat([a[..., :cfg["crop_len"]] for p in pool for a in p])
    bn = {k: v.to(torch.float32) for k, v in ref_cnn14.calibrate_bn(
        {k: v.double() for k, v in params.items()}, clips.double(),
        enc).items()}
    config = Cnn14Config(**enc)
    net = Cnn14(config).to(dev)
    net.load_state_dict({**params, **bn})
    model = ParamModel(net=net, config=config, embed_dim=config.embed_dim)
    chain = chain_from_json(chain_path(traffic))
    chunks = chunks_of(ctx)
    probe = Probe(get_param_embeds, traffic["popsize"], chunks,
                  1 + traffic["replay_generations"],
                  min(chunks, traffic.get("render_chunks", chunks)))
    state = {"model": model, "chain": chain, "pool": pool, "probe": probe,
             "bn_stats": bn}
    run_job(ctx, state, 0, job_seed(ctx["seed"], 999), max_iters=1)
    return state


def run_job(ctx, state, pair: int, seed: int, max_iters=None):
    from st_ito_torch.ito import run_es

    cfg, traffic = ctx["config"], ctx["traffic"]
    x, y = state["pool"][pair]
    return run_es(
        x, y, cfg["sample_rate"], state["chain"], state["model"],
        embed_func=state["probe"],
        max_iters=cfg["max_iters"] if max_iters is None else max_iters,
        find_w0=cfg["find_w0"], sigma0=cfg["sigma0"],
        crop_len=cfg["crop_len"], popsize=traffic["popsize"], seed=seed,
        early_stop_patience=cfg["early_stop_patience"], verbose=False,
        fitness_dtype=cfg["fitness_dtype"],
        gens_per_dispatch=cfg["gens_per_dispatch"],
        chunked=traffic["chunked"], fft_mode=cfg["fft_mode"],
        device=ctx["device"])


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def window(ctx, state):
    from st_ito_torch.utils import phase_timer

    dev, probe = ctx["device"], state["probe"]
    on_card = dev.type == "cuda"
    counters.reset()
    phase_timer.reset(bool(ctx["trace"]))
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    jobs = []
    t0 = time.perf_counter()
    while True:
        j = len(jobs)
        pair = j % len(state["pool"])
        seen = probe.start(render_rows(ctx, j))
        tj = time.perf_counter()
        res = run_job(ctx, state, pair, job_seed(ctx["seed"], j))
        _sync(dev)
        jobs.append({"wall_s": time.perf_counter() - tj, "pair": pair,
                     "time_elapsed": res["time_elapsed"],
                     "evals": seen["items"],
                     "generations": (len(res["fval_history"])
                                     + int(ctx["config"]["find_w0"])),
                     "result": res, "probe": seen})
        if time.perf_counter() - t0 >= ctx["seconds"]:
            break
    window_s = time.perf_counter() - t0
    probe.job = None
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    spans = phase_timer.read_ms() if ctx["trace"] and on_card else {}
    phase_timer.reset(False)
    failed = sum(1 for job in jobs if not _sound(ctx, job))
    return {"jobs": jobs, "window_s": window_s, "peak_bytes": peak,
            "spans": spans, "launches": counters.read(),
            "attempted": len(jobs), "failed": failed,
            "evals": sum(job["evals"] for job in jobs),
            "generations": sum(job["generations"] for job in jobs)}


def _sound(ctx, job) -> bool:
    """The job answered in full: its output, its histories, and as many
    evaluations as it claims and as the probe counted."""
    res, T = job["result"], ctx["traffic"]["samples"]
    out = res["output_audio"]
    hist = np.asarray(res["fval_history"], np.float64)
    return (tuple(out.shape) == (1, 2, T) and bool(torch.isfinite(out).all())
            and hist.size > 0 and bool(np.isfinite(hist).all())
            and np.isfinite(res["fopt"])
            and res["total_evals"] == job["evals"]
            == ctx["traffic"]["popsize"] * job["generations"])


def release(state):
    state.pop("model", None)
    state.pop("chain", None)


# ------------------------------------------------------------ the check


def bf16(t):
    return t.to(torch.bfloat16).to(t.dtype)


def fp8(t):
    scale = 448.0 / torch.clamp_min(t.abs().amax(), 1e-30)
    return (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale


QUANT = {"control": (bf16, fp8), "control_render": (bf16, None),
         "control_embed": (None, fp8)}


def _unit32(e):
    return e / torch.clamp_min(torch.linalg.norm(e, dim=-1, keepdim=True),
                               1e-12)


def _items(out: dict, chunks: int, dev) -> dict:
    """One embed call's outputs as the program hands them on: per item,
    its chunks' mean normalised again (the long-audio mode)."""
    out = {k: v.to(dev) for k, v in out.items()}
    if chunks == 1:
        return out
    return {k: _unit32(v.reshape(v.shape[0] // chunks, chunks, -1).mean(1))
            for k, v in out.items()}


def program_embeds(job, chunks: int, dev) -> dict:
    """{head: (items, D)}: the recorded populations' embeddings per item,
    as the program hands them on, call by call."""
    calls = [_items(out, chunks, dev) for out in job["embeds"]]
    return {k: torch.cat([c[k] for c in calls]) for k in calls[0]}


def program_fitness(job, popsize: int, chunks: int, dev) -> np.ndarray:
    """(generations, popsize): the fitness values the program told its
    search for each recorded population, worked out from its embeddings
    with its own float32 arithmetic on ``dev``, call by call (-cosine to
    the target, the mean over mid and side), so that a replay ranks the
    candidates as the search did, ties included."""
    if job["target"] is None or not job["embeds"]:
        return np.zeros((0, popsize))
    target = _items(job["target"], chunks, dev)
    f = []
    for out in job["embeds"]:
        e = _items(out, chunks, dev)
        d = [-torch.sum(e[k] * target[k], dim=-1)
             / (torch.linalg.norm(e[k], dim=-1)
                * torch.linalg.norm(target[k], dim=-1) + 1e-12)
             for k in e]
        f.append(torch.mean(torch.stack(d, dim=0), dim=0).cpu().numpy())
    f = np.concatenate(f).astype(np.float64)
    gens = f.shape[0] // popsize
    return f[:gens * popsize].reshape(gens, popsize)


def replay(ctx, j: int, res, f_prog: np.ndarray, stall: bool = False):
    """[(generation, population)] of job j as a sound search from its seed
    asks for them, told ``f_prog``: find_w0's draw, then
    ``replay_generations`` asks of the reference CMA-ES. find_w0's best is
    the start; where its best is a near tie, the start is the tied row
    whose first population holds the program's first best vector.
    ``stall``: the state is not told after the first generation."""
    cfg, traffic = ctx["config"], ctx["traffic"]
    seed, pop = job_seed(ctx["seed"], j), traffic["popsize"]
    width = np.asarray(res["wopt"]).size
    W0 = np.random.default_rng(seed).random((pop, width))
    order = np.argsort(f_prog[0])
    ties = [i for i in order[:8] if f_prog[0][i] - f_prog[0][order[0]] < 1e-6]
    start = ties[0]
    first_best = np.asarray(res["wopt_history"][0], np.float64)
    for i in ties:
        es = ref_cmaes.CMAES(W0[i], cfg["sigma0"], pop, seed)
        if np.any(np.all(es.ask() == first_best[None], axis=1)):
            start = i
            break
    es = ref_cmaes.CMAES(W0[start], cfg["sigma0"], pop, seed)
    out = [(0, W0)]
    for g in range(1, traffic["replay_generations"] + 1):
        P = es.ask()
        out.append((g, P))
        if g < traffic["replay_generations"] and not stall:
            es.tell(P, f_prog[g])
    return out


def probed_jobs(ctx, n_jobs: int) -> list[int]:
    rng = np.random.default_rng([ctx["seed"], 1])
    k = min(ctx["traffic"]["probe_jobs"], n_jobs)
    return sorted(rng.choice(n_jobs, size=k, replace=False).tolist())


def sampled_rows(ctx, j: int, g: int) -> list[int]:
    if g == 0:
        return render_rows(ctx, j)
    pop = ctx["traffic"]["popsize"]
    rng = np.random.default_rng([ctx["seed"], j, g])
    k = min(ctx["traffic"]["probe_rows"], pop)
    return sorted(rng.choice(pop, size=k, replace=False).tolist())


def history_vectors(ctx, j: int, res):
    """[(w, the program's fitness of it)]: job j's final best and
    ``check_generations`` earlier entries drawn from the seed."""
    hist = res["fval_history"]
    k = min(ctx["traffic"]["check_generations"], len(hist) - 1)
    rng = np.random.default_rng([ctx["seed"], j])
    picks = sorted(rng.choice(len(hist) - 1, size=k, replace=False).tolist())
    out = [(res["wopt_history"][g], hist[g]) for g in picks]
    out.append((res["wopt"], res["fopt"]))
    return [(np.asarray(w, np.float64), float(f)) for w, f in out]


class Reference:
    """The float64 reference of one run: its Cnn14 weights drawn again
    from the seed, the chain, each pair's target embedding."""

    def __init__(self, ctx, state):
        cfg, traffic, dev = ctx["config"], ctx["traffic"], ctx["device"]
        self.ctx, self.state, self.dev = ctx, state, dev
        self.enc, self.sr = cfg["encoder"], cfg["sample_rate"]
        self.params = {**weights.draw(ctx["seed"],
                                      ref_cnn14.param_specs(self.enc), dev,
                                      dtype=torch.float64),
                       **{k: v.to(torch.float64)
                          for k, v in state["bn_stats"].items()}}
        self.effects = ref_render.load_chain(chain_path(traffic))
        self.chunk = cfg["crop_len"] if traffic["chunked"] else None
        self.guard = 10 * self.sr if traffic["chunked"] else None
        self.targets = {}

    def audio(self, pair: int, which: int):
        a = self.state["pool"][pair][which][0].to(torch.float64)
        return a / a.abs().max()

    def target(self, pair: int):
        if pair not in self.targets:
            self.targets[pair] = ref_cnn14.embed(
                self.params, self.audio(pair, 1)[None], self.enc,
                chunk=self.chunk)
        return self.targets[pair]

    def fitness(self, W: np.ndarray, pair: int, rquant=None, cquant=None):
        """(fitness (n,), renders (n, C, T), embeddings {head: (n, D)}) of
        W (n, P) float64 vectors, formed in float32 as the program forms
        them."""
        W = torch.as_tensor(np.asarray(W, np.float32), device=self.dev)
        Y = ref_render.render_population(
            self.effects, W, self.audio(pair, 0), self.sr, self.guard,
            rquant or ref_render.identity)
        e = ref_cnn14.embed(self.params, Y, self.enc,
                            cquant or ref_cnn14.no_quant, self.chunk)
        target = self.target(pair)
        f = -torch.stack([(e[k] * target[k]).sum(-1) for k in e]).mean(0)
        return f.cpu().numpy(), Y, e

    def output(self, w: np.ndarray, pair: int, rquant=None):
        w = torch.as_tensor(np.asarray(w, np.float32), device=self.dev)
        return ref_render.render_candidate(self.effects, w,
                                           self.audio(pair, 0), self.sr,
                                           rquant or ref_render.identity)


def rms_gap(got, want) -> float:
    got, want = got.to(torch.float64), want.to(torch.float64)
    return float(torch.linalg.vector_norm(got - want)
                 / torch.clamp_min(torch.linalg.vector_norm(want), 1e-30))


def check(ctx, state, rec, mode: str = "program") -> dict:
    """{fitness_gap, embed_gap, render_gap, render_widest, output_gap,
    replay_misses} of the window's jobs (see the module's docstring;
    ``replay_misses`` counts the program's best vectors of the replayed
    generations that the replay did not ask for); the reference's own
    numbers are kept in ``rec`` so that further modes reuse them."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    traffic = ctx["traffic"]
    pop, chunks = traffic["popsize"], chunks_of(ctx)
    if "_reference" not in rec:
        rec["_reference"] = Reference(ctx, state)
    ref = rec["_reference"]
    memo = rec.setdefault("_want", {})
    rquant, cquant = QUANT.get(mode, (None, None))
    gaps = {"fitness_gap": 0.0, "embed_gap": 0.0, "output_gap": 0.0,
            "replay_misses": 0}
    detail = rec.setdefault("_detail", {})[mode] = []

    def widen(name, value, where=None):
        value = float(value)
        value = value if value == value else math.inf
        gaps[name] = max(gaps[name], value)
        if where is not None:
            detail.append((value, name, *where))

    probed = probed_jobs(ctx, len(rec["jobs"]))
    rendered = []  # each compared row's render gap
    for j, job in enumerate(rec["jobs"]):
        res, pair = job["result"], job["pair"]
        rows = []  # (w, the program's value, generation, row)
        f_prog = None
        if j in probed:
            f_prog = program_fitness(job["probe"], pop, chunks, ref.dev)
            if f_prog.shape[0] < 1 + traffic["replay_generations"]:
                widen("fitness_gap", math.inf)
                rendered.append(math.inf)
                f_prog = None
        if f_prog is not None:
            gens = replay(ctx, j, res, f_prog)
            for g, P in gens:
                rows += [(P[r], f_prog[g][r], g, r)
                         for r in sampled_rows(ctx, j, g)]
            asked = np.concatenate([P for g, P in gens if g >= 1])
            gaps["replay_misses"] += sum(
                not np.any(np.all(asked == np.asarray(w)[None], axis=1))
                for w in res["wopt_history"][:len(gens) - 1])
        rows += [(w, f, None, None) for w, f in history_vectors(ctx, j, res)]
        W = np.stack([row[0] for row in rows])
        renders = [i for i, row in enumerate(rows) if row[2] == 0]
        if ("fit", j) not in memo:
            f, Y, e = ref.fitness(W, pair)
            memo[("fit", j)] = f, {i: Y[i] for i in renders}, e
        want, Y_want, e_want = memo[("fit", j)]
        got = np.array([row[1] for row in rows])
        Y_got = {i: job["probe"]["renders"].get(rows[i][3]) for i in renders}
        e_got = None
        if f_prog is not None:
            mine = program_embeds(job["probe"], chunks, ref.dev)
            e_got = {k: {i: mine[k][rows[i][3]] for i in renders}
                     for k in mine}
        if mode in QUANT:
            got, Y, e = ref.fitness(W, pair, rquant, cquant)
            Y_got = {i: Y[i] for i in renders}
            e_got = {k: {i: e[k][i] for i in renders} for k in e}
        elif mode == "fault_unchanged" and f_prog is not None:
            stalled = dict(replay(ctx, j, res, f_prog, stall=True))
            idx = [i for i, row in enumerate(rows)
                   if row[2] is not None and row[2] >= 2]
            if idx:
                got[idx] = ref.fitness(np.stack(
                    [stalled[rows[i][2]][rows[i][3]] for i in idx]), pair)[0]
        elif mode == "fault_half" and f_prog is not None:
            for i, (_, _, g, r) in enumerate(rows):
                if g is not None and r >= pop // 2:
                    got[i] = f_prog[g][r - pop // 2]
        for i, gap in enumerate(np.abs(got - want)):
            widen("fitness_gap", gap,
                  (j, rows[i][2], rows[i][3], float(got[i]), float(want[i])))

        for k, rows_k in (e_got or {}).items():
            for i, got_e in rows_k.items():
                widen("embed_gap", torch.linalg.vector_norm(
                    got_e.to(torch.float64) - e_want[k][i]))

        n = ref.chunk * min(chunks, traffic.get("render_chunks", chunks)) \
            if chunks > 1 else None
        for i in renders:
            if Y_got[i] is None:
                rendered.append(math.inf)
                continue
            y = Y_got[i].to(ref.dev)
            gap = rms_gap(y[..., :n], Y_want[i][..., :n])
            rendered.append(gap)
            detail.append((gap, "render_gap", j, 0, rows[i][3]))

        if ("out", j) not in memo:
            memo[("out", j)] = ref.output(res["wopt"], pair)
        out_want = memo[("out", j)]
        if mode in QUANT:
            out_got = ref.output(res["wopt"], pair, rquant)
        else:
            out_got = res["output_audio"][0].to(ref.dev, torch.float64)
        widen("output_gap", (out_got - out_want).abs().max()
              / out_want.abs().max())
    rendered = [g if g == g else math.inf for g in rendered]
    gaps["render_gap"] = float(np.median(rendered)) if rendered else math.inf
    gaps["render_widest"] = max(rendered, default=math.inf)
    return gaps
