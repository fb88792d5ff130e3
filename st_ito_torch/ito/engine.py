"""Inference-time optimisation — port of ``st_ito_tpu/ito/engine.py``:
the fitness (``_embedding_distance``, ``make_fitness_fn``), ``run_es`` with
its host and device-resident CMA-ES loops, the long-audio mode, staged and
multitrack ES, gradient ITO (``run_autodiff``), and the baselines
``run_input``, ``run_random`` and ``run_rule_based``.

Per generation: CMA-ES asks for a population, on the host (``ito/cmaes.py``,
per generation, at ``gens_per_dispatch=1`` and under ``savepop``, as the JAX
package does) or on the device (``device_es``, ``gens_per_dispatch``
generations per block); the population renderer renders every candidate
with the chain's kernels (the basic chain: K1, then the fused LTI group by
``fft_mode``: K3 -> K4 for "mega2", which "auto" picks, K5 -> K2 -> K4 for
"mega", torch.fft -> K9 -> torch.fft for "mx" and for any length the mega
kernels reject, K10 -> K9 -> K10 for "fused"; the CLI's vst chain: K6,
then K3 -> K4; the style chain: K6, then K8 inside the multiband compressor
and the limiter; a lone unlinked compressor: K7); the Cnn14 embeds the
renders; the fitness is the negative cosine against the target embeddings
(and, with a content model, its distances at twice the weight); CMA-ES is
told the fitness values.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable

import numpy as np
import torch

from st_ito_torch.chain.executor import (build_batched_render_fn,
                                         build_render_fn, parameters_to_dict)
from st_ito_torch.chain.params import ChainSpec
from st_ito_torch.ito import device_es
from st_ito_torch.ito.cmaes import CMAES
from st_ito_torch.models.cnn14 import no_tf32
from st_ito_torch.models.registry import embed_in_chunks, get_param_embeds
from st_ito_torch.ops.iir import next_pow2
from st_ito_torch.parallel.collectives import (all_gather_rows,
                                               gather_rows_to_root, sharded,
                                               shard_rows)
from st_ito_torch.utils import (batch_peak_normalize, phase_timer,
                                resolve_device, save_audio)

# The chunked (long-audio) fitness's peak device memory per candidate and per
# sample of its LTI FFT grid, as chip_smoke.py's long phase measured it on
# an NVIDIA H100 80GB HBM3 at 700 W (max_memory_allocated over the timed
# block less what was allocated before it, over the sub-batch: the render,
# the ten-chunk bf16 embed and their temporaries at T 2880000, grid 2^22,
# sub-batch 64: 93.45 bytes), rounded up.
LONG_BYTES_PER_FFT_SAMPLE = 94
# The share of the device's free memory the automatic sub-batch may fill.
LONG_FREE_SHARE = 0.75


def _embedding_distance(output_embeds, target_embeds, content_scale=None):
    """(heads, B) -cosine(out, target) per head, times ``content_scale``
    when given."""
    dists = []
    for name, out in output_embeds.items():
        tgt = target_embeds[name]
        d = -torch.sum(out * tgt, dim=-1) / (
            torch.linalg.norm(out, dim=-1) * torch.linalg.norm(tgt, dim=-1)
            + 1e-12)
        if content_scale is not None:
            d = content_scale * d
        dists.append(d)
    return torch.stack(dists, dim=0)


def _resolve_fitness_dtype(compute_dtype: str | None, device) -> str:
    """bfloat16 for the conv stack on the card, float32 elsewhere."""
    if compute_dtype is not None:
        return compute_dtype
    return "bfloat16" if device.type == "cuda" else "float32"


def _model_dtype_variant(model, compute_dtype: str):
    """``model`` with its config's compute_dtype set, where it has one."""
    cfg = getattr(model, "config", None)
    if (cfg is None or not hasattr(cfg, "compute_dtype")
            or cfg.compute_dtype == compute_dtype
            or not dataclasses.is_dataclass(model)):
        return model
    return dataclasses.replace(
        model, config=dataclasses.replace(cfg, compute_dtype=compute_dtype))


def _check_mesh(mesh, dev) -> bool:
    """Whether this process leads (writes files and prints): rank 0 of
    ``mesh``, or the only process. Raises where the mesh's ranks are not
    on ``dev``'s kind of device."""
    if mesh is None:
        return True
    if mesh.device.type != dev.type:
        raise ValueError(f"the mesh's ranks run on {mesh.device}, the "
                         f"entry point on {dev}")
    return mesh.rank == 0


def make_fitness_fn(chain: ChainSpec, model, sample_rate: int,
                    num_channels: int, embed_func: Callable = get_param_embeds,
                    content_model=None, content_embed_func=None,
                    dropout: float = 0.0, normalize_stages: bool = False,
                    mesh=None, return_audio: bool = False,
                    compute_dtype: str | None = None,
                    fft_precision: str = "high", fft_mode: str = "auto",
                    pop_microbatch: int | None = None,
                    renderer_fast: bool = True,
                    max_lti_pad: int | None = None, device="cuda"):
    """``fitness(W (pop, P), x (C, T), target_embeds,
    target_content_embeds=None, rng=None) -> fvals (pop,)`` on ``device``
    (or ``(fvals, embeds, audio)`` with return_audio).

    ``compute_dtype``: the Cnn14 conv stack's precision; defaults to
    bfloat16 on the card and float32 on the CPU. ``content_model``: its
    embeddings (``content_embed_func``) against ``target_content_embeds``
    join the style distances at twice their weight. ``dropout`` > 0: the
    embed drops embedding elements with masks drawn from ``rng``, a
    ``torch.Generator`` on the device. ``pop_microbatch``: score the
    population in sub-batches of this size when it divides the population;
    ignored with return_audio or dropout > 0 (the masks would repeat across
    sub-batches), as in the JAX package. ``fft_mode``: how the renderer
    applies the fused LTI group (``build_batched_render_fn``);
    ``max_lti_pad`` caps its tail guard. The renderer's output normalisation
    is skipped when every embed peak-normalises its input.
    ``normalize_stages`` renders each candidate through the per-candidate
    ``build_render_fn`` instead (plain PyTorch, no kernel). An
    ``embed_func`` marked ``host_side`` (the JAX package's mark for an
    embed its jitted program cannot trace) is scored as any other: the
    port has no trace barrier.

    ``mesh`` (``parallel.make_mesh``, axis "pop"): every rank is called
    with the whole W; it renders and embeds its rows [r pop / w, (r + 1)
    pop / w), its dropout masks its rows of the whole population's
    (``parallel.global_draw``, so every rank's ``rng`` advances as one
    process's does), and the fitness values are all-gathered: every rank
    returns the whole (pop,). With return_audio the embeddings are
    all-gathered and the renders gathered to rank 0 (None elsewhere).
    ``pop_microbatch`` is ignored under a mesh, as in the JAX package."""
    dev = resolve_device(device)
    _check_mesh(mesh, dev)
    if return_audio or dropout > 0.0 or mesh is not None:
        pop_microbatch = None
    model = _model_dtype_variant(model,
                                 _resolve_fitness_dtype(compute_dtype, dev))
    if normalize_stages:
        # per-stage normalisation does not fuse: every candidate goes
        # through the per-candidate renderer, as the JAX package renders it
        # under vmap (st_ito_tpu/ito/engine.py:163-169)
        per_render = build_render_fn(chain, sample_rate, num_channels,
                                     normalize_stages=True, device=dev)

        def render(W, x):
            return torch.stack([per_render(w, x) for w in W])
    else:
        skip_norm = (not return_audio
                     and getattr(embed_func, "peak_normalizes_input", False)
                     and (content_model is None
                          or getattr(content_embed_func,
                                     "peak_normalizes_input", False)))
        render = build_batched_render_fn(
            chain, sample_rate, num_channels, fast=renderer_fast,
            fft_mode=fft_mode, fft_precision=fft_precision,
            peak_normalize_output=not skip_norm, max_lti_pad=max_lti_pad,
            device=dev)

    def score(W, x, target_embeds, target_content_embeds, rng):
        with phase_timer.span("render", dev):
            Y = render(W, x)
        with phase_timer.span("embed", dev):
            kw = {"dropout": dropout, "generator": rng} if dropout > 0 else {}
            out = embed_func(Y, model, sample_rate, **kw)
            dists = _embedding_distance(out, target_embeds)
            if content_model is not None and target_content_embeds is not None:
                cout = content_embed_func(Y, content_model, sample_rate)
                dists = torch.cat([dists, _embedding_distance(
                    cout, target_content_embeds, content_scale=2.0)])
            fvals = torch.mean(dists, dim=0)
        return fvals, out, Y

    @torch.no_grad()
    def fitness(W, x, target_embeds, target_content_embeds=None, rng=None):
        W = torch.as_tensor(W, dtype=torch.float32, device=dev)
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        if mesh is not None:
            with sharded(mesh):
                fv, out, Y = score(shard_rows(W, mesh), x, target_embeds,
                                   target_content_embeds, rng)
            fv = all_gather_rows(fv, mesh)
            if not return_audio:
                return fv
            return (fv, {k: all_gather_rows(v, mesh) for k, v in out.items()},
                    gather_rows_to_root(Y, mesh))
        if return_audio:
            return score(W, x, target_embeds, target_content_embeds, rng)
        mb = pop_microbatch
        if mb and W.shape[0] > mb and W.shape[0] % mb == 0:
            return torch.cat([
                score(Wi, x, target_embeds, target_content_embeds, rng)[0]
                for Wi in W.split(mb)])
        return score(W, x, target_embeds, target_content_embeds, rng)[0]

    return fitness


def _crop_or_pad(x: torch.Tensor, start: int, crop_len: int) -> torch.Tensor:
    """The window [start, start + crop_len) of x's last axis, or x padded
    with zeros to crop_len when shorter."""
    T = x.shape[-1]
    if T > crop_len:
        return x[..., start:start + crop_len]
    if T < crop_len:
        return torch.nn.functional.pad(x, (0, crop_len - T))
    return x


_CHUNKED_EMBED_CACHE: dict = {}


def _chunked_embed_for(base_embed: Callable, chunk_len: int,
                       hop: int | None = None) -> Callable:
    """Long-audio wrapper of any embed (``registry.embed_in_chunks``):
    chunks of ``chunk_len`` every ``hop`` samples embedded as one batch,
    averaged per item and L2-normalised again. One wrapper per (base,
    chunk_len, hop), as in the JAX package, so repeated runs get the same
    embed function."""
    key = (base_embed, chunk_len, hop)
    if key not in _CHUNKED_EMBED_CACHE:
        def chunked(x, model, sample_rate, **kwargs):
            return embed_in_chunks(base_embed, x, model, sample_rate,
                                   chunk_len, hop, **kwargs)

        chunked.peak_normalizes_input = getattr(
            base_embed, "peak_normalizes_input", False)
        _CHUNKED_EMBED_CACHE[key] = chunked
    return _CHUNKED_EMBED_CACHE[key]


def _free_bytes(device) -> int:
    """The memory a run on ``device`` can still take: on the card its free
    memory as CUDA reports it (``torch.cuda.mem_get_info``) and what
    PyTorch's allocator holds unused; on the CPU the host's available
    pages."""
    if device.type == "cuda":
        return (torch.cuda.mem_get_info(device)[0]
                + torch.cuda.memory_reserved(device)
                - torch.cuda.memory_allocated(device))
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def _long_microbatch(popsize: int, T: int, max_lti_pad: int,
                     device) -> int | None:
    """The automatic sub-batch of the chunked mode: the population halved,
    while it stays even and above 8, until its measured peak bytes
    (``LONG_BYTES_PER_FFT_SAMPLE`` per candidate and sample of the FFT
    grid) fit ``LONG_FREE_SHARE`` of the device's free memory; None when
    the whole population fits."""
    per_cand = LONG_BYTES_PER_FFT_SAMPLE * next_pow2(T + max_lti_pad)
    budget = LONG_FREE_SHARE * _free_bytes(device)
    mb = popsize
    while mb > 8 and mb % 2 == 0 and mb * per_cand > budget:
        mb //= 2
    return mb if mb < popsize else None


def _peak_norm(x, device) -> torch.Tensor:
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    return x / torch.clamp_min(x.abs().max(), 1e-8)


def run_es(input_audio, target_audio, sample_rate: int, chain: ChainSpec,
           model, embed_func: Callable = get_param_embeds, content_model=None,
           content_embed_func=None, max_iters: int = 100, w0=None,
           find_w0: bool = True, sigma0: float = 0.1,
           distance: str = "cosine", random_crop: bool = False,
           crop_len: int = 262144, popsize: int = 32, parallel: bool = True,
           dropout: float = 0.0, savepop: bool = False, run_dir: str = ".",
           normalize_stages: bool = False, seed: int = 0, mesh=None,
           early_stop_patience: int = 10,
           early_stop_threshold: float = -0.01, verbose: bool = True,
           es_state_path: str | None = None,
           fitness_dtype: str | None = None, gens_per_dispatch: int = 1,
           opt_slice=None, w_template=None, chunked: bool = False,
           fft_mode: str = "auto", pop_microbatch: int | None = None,
           device="cuda"):
    """CMA-ES inference-time optimisation on ``device`` (default the card).

    input_audio/target_audio: (1, C, T) arrays or tensors. Returns the JAX
    package's result dict: output_audio, params, fopt, wopt, fval_history,
    wopt_history, time_elapsed, total_evals, evals_per_sec.

    ``gens_per_dispatch`` > 1 (and no ``savepop``) runs the device-resident
    CMA-ES (``device_es``), that many generations per block with one host
    fetch of their statistics per block; otherwise the host ``CMAES`` runs
    one generation at a time, as in the JAX package: the same seed then
    asks for the JAX package's populations bit for bit. Dropout is off in
    the final generation (the device loop runs it as a block of its own).

    ``chunked=True`` (the long-audio mode) renders every candidate on the
    whole input, the LTI tail guard capped at 10 s, and scores it with
    embeddings of chunks of ``crop_len`` averaged over the signal
    (``_chunked_embed_for``); without a ``pop_microbatch`` the population
    is scored in sub-batches that fit the device (``_long_microbatch``).
    ``opt_slice=(start, end)`` optimises that slice of the parameter
    vector only, the rest frozen at ``w_template`` (default the chain's
    init); ``w0`` is then slice-wide and ``wopt_history`` holds full
    vectors. ``es_state_path``: an .npz snapshot of the ES state (the JAX
    package's keys), written every generation (host loop) or block (device
    loop) and resumed from at the start if the file exists. ``savepop``
    writes each generation's renders, ranked by fitness, to
    ``run_dir/pop_{i}`` (``pop_-1`` for find_w0's). ``find_w0`` draws the
    same ``W_init`` as the JAX package: numpy's ``default_rng(seed)``.

    ``output_audio`` is rendered per candidate (``build_render_fn``), as in
    the JAX package: stage by stage, the delay's tail truncated at the
    buffer end before the reverb, where the population renderer's fused
    group lets it through. Its time is outside ``time_elapsed``.

    ``mesh`` (axis "pop"): every rank runs this function with the same
    arguments; the CMA-ES state is replicated (every rank asks for the same
    population from the same seed), each rank scores its rows of it
    (``make_fitness_fn``) and every rank is told the gathered fitness, so
    every rank returns the same result. Only rank 0 writes the snapshots
    and ``savepop``'s renders and prints; every rank reads a snapshot on
    resume. The chunked mode's automatic sub-batch is skipped under a
    mesh, as in the JAX package."""
    dev = resolve_device(device)
    lead = _check_mesh(mesh, dev)
    verbose = verbose and lead
    if distance != "cosine":
        raise ValueError(f"distance={distance!r}: only 'cosine' exists")
    del parallel  # the population always renders in parallel
    rng = np.random.default_rng(seed)
    generator = torch.Generator(device=dev).manual_seed(seed)
    crop_generator = torch.Generator().manual_seed(seed)

    if chunked:
        embed_func = _chunked_embed_for(embed_func, chunk_len=crop_len)
        random_crop = False

    input_audio = _peak_norm(input_audio, dev)
    target_audio = _peak_norm(target_audio, dev)
    target_embed = embed_func(target_audio, model, sample_rate)
    target_content_embed = None
    if content_model is not None:
        target_content_embed = content_embed_func(target_audio,
                                                  content_model, sample_rate)

    lift = None
    opt_width = chain.num_params
    if opt_slice is not None:
        s0, s1 = opt_slice
        opt_width = s1 - s0
        template = np.asarray(w_template if w_template is not None
                              else chain.init_params(), np.float64)
        lift = (torch.as_tensor(template, dtype=torch.float32, device=dev),
                s0)

    def lift_np(w):
        if lift is None:
            return w
        full = template.copy()
        full[s0:s1] = w
        return full

    x_full = input_audio[0]  # (C, T)
    T = x_full.shape[-1]
    # never longer than the signal: padding candidates to crop_len would
    # dilute their embeddings with silence while the target's stays unpadded
    eval_len = T if chunked else min(T, crop_len)
    # the chunked mode caps the fused LTI group's tail guard at 10 s (the
    # longest reverb tail), as the JAX package does: FFTs of
    # next_pow2(T + 10 s), not of next_pow2(2 T)
    max_lti_pad = min(T, 10 * int(sample_rate)) if chunked else None
    if chunked and pop_microbatch is None and mesh is None and not savepop:
        pop_microbatch = _long_microbatch(popsize, T, max_lti_pad, dev)

    common = dict(normalize_stages=normalize_stages, mesh=mesh,
                  return_audio=savepop, compute_dtype=fitness_dtype,
                  fft_mode=fft_mode, pop_microbatch=pop_microbatch,
                  max_lti_pad=max_lti_pad, device=dev)
    fitness = make_fitness_fn(chain, model, sample_rate, x_full.shape[0],
                              embed_func, content_model, content_embed_func,
                              dropout, **common)
    # the final generation runs without dropout, from a second fitness
    fitness_nodrop = fitness if dropout == 0.0 else make_fitness_fn(
        chain, model, sample_rate, x_full.shape[0], embed_func,
        content_model, content_embed_func, 0.0, **common)

    def eval_W(W, dropout_active=True):
        """(fvals as numpy, the renders with savepop) of W (pop, width)."""
        start = 0
        if random_crop and (T - crop_len) > 16384:
            start = int(rng.integers(16384, T - crop_len))
        x = _crop_or_pad(x_full, start, eval_len)
        W = torch.as_tensor(np.asarray(W), dtype=torch.float32, device=dev)
        if lift is not None:
            W = device_es.lift_slice(lift[0], W, s0)
        fit = fitness if dropout_active else fitness_nodrop
        out = fit(W, x, target_embed, target_content_embed, generator)
        if savepop:
            return out[0].cpu().numpy(), out[2]
        return out.cpu().numpy(), None

    t_start = time.time()
    total_evals = 0
    if find_w0:
        W_init = rng.random((popsize, opt_width))
        fvals, audio = eval_W(W_init)
        total_evals += popsize
        w0 = W_init[int(np.argmin(fvals))]
        if savepop and lead:
            _savepop_to_disk(-1, fvals, audio, run_dir, sample_rate)
    elif w0 is None:
        w0 = np.full(opt_width, 0.5)
    else:
        w0 = np.asarray(w0, np.float64)

    es_resume_state = None
    if es_state_path is not None and os.path.isfile(es_state_path):
        with np.load(es_state_path) as snap:
            es_resume_state = {k: snap[k] for k in snap.files}

    fval_history: list[float] = []
    wopt_history: list[np.ndarray] = []
    if gens_per_dispatch > 1 and not savepop:
        wopt, fopt, total_evals = _run_es_device_loop(
            fitness, fitness_nodrop, opt_width, lift, lift_np, x_full,
            target_embed, target_content_embed, w0, sigma0, popsize,
            max_iters, dropout, gens_per_dispatch, random_crop, crop_len,
            eval_len, early_stop_patience, early_stop_threshold, verbose,
            es_state_path if lead else None, es_resume_state, generator,
            crop_generator, total_evals, fval_history, wopt_history, dev)
    else:
        es = CMAES(w0, sigma0, popsize=popsize, bounds=(0.0, 1.0), seed=seed)
        if es_resume_state is not None:
            es.load_state_dict(es_resume_state)
            if verbose:
                print(f"resumed ES state from {es_state_path} "
                      f"(gen {es.generation})")
        iters_without_improvement = 0
        for iteration in range(max_iters):
            # ask and tell are numpy alone (host spans); the fetch in
            # eval_W synchronises, so the generation's events read its
            # wall time
            with phase_timer.span("generation", dev):
                with phase_timer.host_span("ask"):
                    W = es.ask()
                fvals, audio = eval_W(
                    W, dropout_active=(iteration + 1 < max_iters))
                total_evals += popsize
                with phase_timer.host_span("tell"):
                    # the best BEFORE this generation
                    prev_best = min(fval_history) if fval_history else None
                    es.tell(W, fvals)
                    if verbose:
                        es.disp()
                    wopt_history.append(lift_np(es.result[0]))
                    fval_history.append(es.result[1])
                    # early stopping: this generation's best against the
                    # best of all the generations before it
                    fval_delta = (float(np.min(fvals)) - prev_best
                                  if prev_best is not None else -0.02)
                    if fval_delta > early_stop_threshold:
                        iters_without_improvement += 1
                    else:
                        iters_without_improvement = 0
            if es_state_path is not None and lead:
                np.savez(es_state_path, **es.state_dict())
            if savepop and lead:
                _savepop_to_disk(iteration, fvals, audio, run_dir,
                                 sample_rate)
            if iters_without_improvement > early_stop_patience:
                if verbose:
                    print("Stopping early due to no improvement.")
                break
        wopt, fopt = es.result
        wopt = lift_np(wopt)
    elapsed = time.time() - t_start

    render = build_render_fn(chain, sample_rate, x_full.shape[0],
                             normalize_stages, device=dev)
    output_audio = render(torch.as_tensor(wopt, dtype=torch.float32),
                          x_full)[None]
    return {
        "output_audio": output_audio,
        "params": parameters_to_dict(wopt, chain),
        "fopt": fopt,
        "wopt": wopt,
        "fval_history": fval_history,
        "wopt_history": wopt_history,
        "time_elapsed": elapsed,
        "total_evals": total_evals,
        "evals_per_sec": total_evals / max(elapsed, 1e-9),
    }


def _run_es_device_loop(fitness, fitness_nodrop, opt_width, lift, lift_np,
                        x_full, target_embed, target_content_embed, w0,
                        sigma0, popsize, max_iters, dropout,
                        gens_per_dispatch, random_crop, crop_len, eval_len,
                        early_stop_patience, early_stop_threshold, verbose,
                        es_state_path, es_resume_state, generator,
                        crop_generator, total_evals, fval_history,
                        wopt_history, device):
    """k generations per block (see run_es). Appends to fval_history and
    wopt_history in place; returns (wopt, fopt, total_evals)."""
    consts = device_es.cma_consts(opt_width, popsize, device)
    if es_resume_state is not None:
        state = device_es.state_from_dict(es_resume_state, device)
        if verbose:
            print(f"resumed ES state from {es_state_path} "
                  f"(gen {state.generation})")
    else:
        state = device_es.cma_init(w0, sigma0, device)
    T = x_full.shape[-1]
    if random_crop and (T - crop_len) > 16384:
        x_eval, blk_crop = x_full, crop_len
    else:
        x_eval, blk_crop = _crop_or_pad(x_full, 0, eval_len), None

    def block(fit, k):
        """One block of k generations; its (k, N + 2) statistics."""
        nonlocal state
        runner = device_es.make_block_runner(fit, consts, crop_len=blk_crop)
        state, stats = runner(state, x_eval, target_embed, k, generator,
                              crop_generator, target_content_embed, lift)
        packed = stats.cpu().numpy()  # the block's one host fetch
        if es_state_path is not None:
            np.savez(es_state_path, **device_es.state_to_dict(state))
        return packed

    # the final generation runs without dropout, as a block of its own
    main_gens = max_iters if dropout == 0.0 else max_iters - 1
    stopped = False
    done = 0
    iters_without_improvement = 0
    while done < main_gens and not stopped:
        k = min(gens_per_dispatch, main_gens - done)
        packed = block(fitness, k)
        gen_min, best_f, best_x = packed[:, 0], packed[:, 1], packed[:, 2:]
        for j in range(k):
            prev_best = min(fval_history) if fval_history else None
            total_evals += popsize
            fval_history.append(float(best_f[j]))
            wopt_history.append(lift_np(best_x[j].astype(np.float64)))
            if verbose:
                print(f"gen {done + j + 1:4d}  evals {total_evals:6d}  "
                      f"fbest {best_f[j]:+.6f}")
            fval_delta = (float(gen_min[j]) - prev_best
                          if prev_best is not None else -0.02)
            if fval_delta > early_stop_threshold:
                iters_without_improvement += 1
            else:
                iters_without_improvement = 0
            if iters_without_improvement > early_stop_patience:
                if verbose:
                    print("Stopping early due to no improvement.")
                stopped = True
                break
        done += k

    if dropout > 0.0 and not stopped and max_iters > 0:
        packed = block(fitness_nodrop, 1)
        total_evals += popsize
        fval_history.append(float(packed[0, 1]))
        wopt_history.append(lift_np(packed[0, 2:].astype(np.float64)))

    wopt = (wopt_history[-1] if wopt_history
            else lift_np(np.asarray(w0, np.float64)))
    fopt = fval_history[-1] if fval_history else float("inf")
    return wopt, fopt, total_evals


def _savepop_to_disk(iteration, fvals, audio, run_dir, sample_rate):
    """Write one generation's renders to ``run_dir/pop_{iteration}``, each
    peak-normalised, named by rank and fitness."""
    pop_dir = os.path.join(run_dir, f"pop_{iteration}")
    os.makedirs(pop_dir, exist_ok=True)
    audio = audio.detach().cpu().numpy()
    for rank, idx in enumerate(np.argsort(fvals)):
        a = audio[idx]
        a = a / max(np.abs(a).max(), 1e-8)
        save_audio(os.path.join(
            pop_dir, f"output_audio_pop_{rank}_fval_{fvals[idx]:0.4e}.wav"),
            a, sample_rate)


# --------------------------------------------------------------------------
# batched multi-track ES
# --------------------------------------------------------------------------


def run_es_multitrack(input_audio, target_audio, sample_rate: int,
                      chain: ChainSpec, model,
                      embed_func: Callable = get_param_embeds,
                      max_iters: int = 32, popsize: int = 32,
                      sigma0: float = 0.33, dropout: float = 0.0,
                      seed: int = 0, mesh=None, verbose: bool = False,
                      fitness_dtype: str | None = None, device="cuda"):
    """An independent host CMA-ES per track (seeded ``seed + t``); every
    generation renders and embeds all tracks' populations in one call of
    the population renderer on per-candidate input, (tracks · pop, C, T).

    input_audio/target_audio: (tracks, C, T). Returns output_audio
    (tracks, C, T), rendered by the same batched renderer, and per track
    params, fopt, wopt and fval_history, with time_elapsed, total_evals and
    evals_per_sec.

    ``mesh`` (axis "pop"): each rank renders and embeds its rows of the
    flat (tracks · pop) axis, with their input copies and target
    embeddings, its dropout masks its rows of the whole axis's; the fitness
    values are all-gathered, so every rank's host CMA-ES per track is told
    the same values and every rank returns the same result."""
    dev = resolve_device(device)
    verbose = verbose and _check_mesh(mesh, dev)

    input_audio, target_audio = (
        batch_peak_normalize(torch.as_tensor(a, dtype=torch.float32,
                                             device=dev))
        for a in (input_audio, target_audio))
    tracks, channels = input_audio.shape[:2]
    target_embeds = embed_func(target_audio, model, sample_rate)
    model = _model_dtype_variant(model,
                                 _resolve_fitness_dtype(fitness_dtype, dev))
    render = build_batched_render_fn(chain, sample_rate, channels, fast=True,
                                     device=dev)

    # the one copy of the input per candidate, as the JAX package's _rep:
    # flat row i holds track i // popsize (this rank's rows under a mesh)
    rows = torch.arange(tracks * popsize, device=dev)
    if mesh is not None:
        rows = shard_rows(rows, mesh)
    track_of = rows // popsize
    x_flat = input_audio.index_select(0, track_of)
    targets = {"mid": target_embeds["mid"],
               "side": target_embeds.get("side", target_embeds["mid"])}
    targets = {k: v.index_select(0, track_of) for k, v in targets.items()}
    generator = torch.Generator(device=dev).manual_seed(seed)

    @torch.no_grad()
    def fitness(W_flat):
        if mesh is not None:
            W_flat = shard_rows(W_flat, mesh)
        Y = render(W_flat, x_flat)
        with phase_timer.span("embed", dev), sharded(mesh):
            kw = ({"dropout": dropout, "generator": generator}
                  if dropout > 0 else {})
            embeds = embed_func(Y, model, sample_rate, **kw)
            dists = [-torch.sum(out * targets[name], dim=-1)
                     for name, out in embeds.items() if name in targets]
            fvals = torch.mean(torch.stack(dists), dim=0)
        return fvals if mesh is None else all_gather_rows(fvals, mesh)

    num_params = chain.num_params
    ess = [CMAES(np.full(num_params, 0.5), sigma0, popsize=popsize,
                 bounds=(0.0, 1.0), seed=seed + t) for t in range(tracks)]
    t_start = time.time()
    total_evals = 0
    fval_history = [[] for _ in range(tracks)]
    for iteration in range(max_iters):
        Ws = [es.ask() for es in ess]
        W_flat = torch.as_tensor(np.concatenate(Ws), dtype=torch.float32,
                                 device=dev)
        fvals = fitness(W_flat).cpu().numpy()
        total_evals += tracks * popsize
        for t, es in enumerate(ess):
            es.tell(Ws[t], fvals[t * popsize:(t + 1) * popsize])
            fval_history[t].append(es.result[1])
        if verbose:
            print(f"gen {iteration}: " + " ".join(
                f"{es.result[1]:+.4f}" for es in ess))
    elapsed = time.time() - t_start

    wopt = np.stack([es.result[0] for es in ess])
    output_audio = render(torch.as_tensor(wopt, dtype=torch.float32),
                          input_audio)
    return {
        "output_audio": output_audio,
        "params": [parameters_to_dict(w, chain) for w in wopt],
        "fopt": [es.result[1] for es in ess],
        "wopt": wopt,
        "fval_history": fval_history,
        "time_elapsed": elapsed,
        "total_evals": total_evals,
        "evals_per_sec": total_evals / max(elapsed, 1e-9),
    }


# --------------------------------------------------------------------------
# staged ES
# --------------------------------------------------------------------------


def run_staged_es(input_audio, target_audio, sample_rate: int,
                  chain: ChainSpec, model,
                  embed_func: Callable = get_param_embeds,
                  max_iters: int = 25, popsize: int = 32,
                  sigma0: float = 0.33, dropout: float = 0.0, seed: int = 0,
                  mesh=None, verbose: bool = True,
                  early_stop_patience: int = 10,
                  early_stop_threshold: float = -0.01, savepop: bool = False,
                  run_dir: str = ".", es_state_path: str | None = None,
                  gens_per_dispatch: int = 1, device="cuda", **kwargs):
    """Optimise one stage at a time, earlier stages frozen at their optimum.

    Each stage is a ``run_es`` with ``opt_slice`` (the frozen template the
    vector so far, the stage's start its slice of it), seeded ``seed +
    stage_idx``, with the full ES loop: early stopping, savepop into
    ``run_dir/stage_{i}_{name}``, snapshots in
    ``{es_state_path}.stage{i}.npz`` (a resumed run replays the finished
    stages, which stop early at once). ``kwargs`` go to ``run_es``, but for
    find_w0, w0, opt_slice and w_template, which each stage sets. ``mesh``
    goes to every stage's ``run_es``: rank 0 alone writes and prints."""
    dev = resolve_device(device)
    verbose = verbose and _check_mesh(mesh, dev)
    w_full = np.asarray(chain.init_params(), np.float64)
    fval_history: list[float] = []
    wopt_history: list[np.ndarray] = []
    total_evals = 0
    t_start = time.time()
    for k in ("find_w0", "w0", "opt_slice", "w_template"):
        kwargs.pop(k, None)

    for stage_idx, (stage, start, end) in enumerate(chain.stage_slices()):
        res = run_es(
            input_audio, target_audio, sample_rate, chain, model,
            embed_func=embed_func, max_iters=max_iters, popsize=popsize,
            sigma0=sigma0, dropout=dropout, find_w0=False,
            w0=w_full[start:end].copy(), opt_slice=(start, end),
            w_template=w_full, seed=seed + stage_idx, mesh=mesh,
            verbose=False, early_stop_patience=early_stop_patience,
            early_stop_threshold=early_stop_threshold, savepop=savepop,
            run_dir=(os.path.join(run_dir, f"stage_{stage_idx}_{stage.name}")
                     if savepop else run_dir),
            es_state_path=(f"{es_state_path}.stage{stage_idx}.npz"
                           if es_state_path else None),
            gens_per_dispatch=gens_per_dispatch, device=dev, **kwargs)
        w_full = np.asarray(res["wopt"], np.float64)
        fval_history.extend(res["fval_history"])
        wopt_history.extend(res["wopt_history"])
        total_evals += res["total_evals"]
        if verbose:
            print(f"stage {stage.name}: fbest {res['fopt']:+.5f} "
                  f"({len(res['fval_history'])} gens)")

    elapsed = time.time() - t_start
    render = build_render_fn(chain, sample_rate, input_audio.shape[1],
                             device=dev)
    output_audio = render(torch.as_tensor(w_full, dtype=torch.float32),
                          _peak_norm(input_audio, dev)[0])[None]
    return {
        "output_audio": output_audio,
        "params": parameters_to_dict(w_full, chain),
        "fopt": fval_history[-1] if fval_history else np.inf,
        "wopt": w_full,
        "fval_history": fval_history,
        "wopt_history": wopt_history,
        "time_elapsed": elapsed,
        "total_evals": total_evals,
        "evals_per_sec": total_evals / max(elapsed, 1e-9),
    }


# --------------------------------------------------------------------------
# gradient ITO
# --------------------------------------------------------------------------


def autodiff_loss_fn(input_audio, target_audio, sample_rate: int, model,
                     embed_func: Callable = get_param_embeds,
                     chain: ChainSpec | None = None, dropout: float = 0.0,
                     seed: int = 0, device="cuda"):
    """``(loss(theta (P,)) -> 0-d tensor, P, render(w (P,)) -> (1, C, T))``
    of gradient ITO on ``device``: theta through a sigmoid to w in (0, 1),
    rendered by the 51-parameter complex processor (``proc.py``) when
    ``chain`` is None, else by the chain's per-candidate renderer
    (``build_render_fn``), embedded, and scored as the mean embedding
    distance to the target's. Both inputs are peak-normalised first.
    With ``dropout`` > 0 the embed's masks come from a ``torch.Generator``
    on the device seeded with ``seed``."""
    from st_ito_torch import proc

    dev = resolve_device(device)
    input_audio = _peak_norm(input_audio, dev)
    with torch.no_grad():
        target_embed = embed_func(_peak_norm(target_audio, dev), model,
                                  sample_rate)

    if chain is None:
        num_params = proc.NUM_COMPLEX_PARAMS

        def render_batch(w):
            return proc.apply_complex_autodiff_processor(
                input_audio, w[None], sample_rate)
    else:
        num_params = chain.num_params
        render = build_render_fn(chain, sample_rate, input_audio.shape[1],
                                 device=dev)

        def render_batch(w):
            return render(w, input_audio[0])[None]

    kw = {}
    if dropout > 0:
        kw = {"dropout": dropout,
              "generator": torch.Generator(device=dev).manual_seed(seed)}

    def loss_fn(theta):
        y = render_batch(torch.sigmoid(theta))
        out_embeds = embed_func(y, model, sample_rate, **kw)
        return torch.mean(_embedding_distance(out_embeds, target_embed))

    return loss_fn, num_params, render_batch


def autodiff_step(loss_fn, theta: torch.Tensor) -> torch.Tensor:
    """One forward and backward pass of ``loss_fn`` at ``theta`` (a leaf
    that requires grad), both with TF32 off (``no_tf32``): cuDNN's
    convolution gradients run inside ``backward``, where its default would
    round them to TF32 on the card. Returns the loss; ``theta.grad`` holds
    the gradient."""
    with no_tf32():
        loss = loss_fn(theta)
        loss.backward()
    return loss


def run_autodiff(input_audio, target_audio, sample_rate: int, model,
                 embed_func: Callable = get_param_embeds,
                 chain: ChainSpec | None = None, lr: float = 1e-2,
                 n_iters: int = 300, dropout: float = 0.0, seed: int = 0,
                 verbose: bool = True, device="cuda", **kwargs):
    """Gradient ITO on ``device`` (default the card): Adam at ``lr`` on
    theta, from theta = 0 (w = 0.5), through ``autodiff_loss_fn``'s
    differentiable render and embed; any chain, or the 51-parameter
    processor with ``chain=None``. torch's Adam (eps 1e-8) is optax's
    ``adam`` up to float32 rounding. Each step is ``autodiff_step``, so
    the encoder's convolutions and their gradients are float32 on the
    card. ``kwargs`` are accepted and ignored, as in the JAX package.

    Returns the JAX package's keys: output_audio (on the device), params,
    fopt (the last step's loss), wopt, fval_history (each step's loss, at
    theta before its update), wopt_history, time_elapsed, total_evals (one
    per step) and evals_per_sec."""
    del kwargs
    dev = resolve_device(device)
    loss_fn, num_params, render_batch = autodiff_loss_fn(
        input_audio, target_audio, sample_rate, model, embed_func, chain,
        dropout, seed, dev)
    theta = torch.zeros(num_params, device=dev, requires_grad=True)
    opt = torch.optim.Adam([theta], lr=lr, eps=1e-8)

    fval_history: list[float] = []
    wopt_history: list[np.ndarray] = []
    t_start = time.time()
    for i in range(n_iters):
        opt.zero_grad(set_to_none=True)
        loss = autodiff_step(loss_fn, theta)
        opt.step()
        fval_history.append(loss.item())
        wopt_history.append(torch.sigmoid(theta).detach().cpu().numpy())
        if verbose and (i % 25 == 0 or i == n_iters - 1):
            print(f"iter {i:4d}  loss {fval_history[-1]:+.6f}")
    elapsed = time.time() - t_start

    with torch.no_grad():
        w = torch.sigmoid(theta)
        output_audio = render_batch(w)
    w = w.cpu().numpy()
    params = (parameters_to_dict(w, chain) if chain is not None
              else {f"{i}": float(v) for i, v in enumerate(w)})
    return {
        "output_audio": output_audio,
        "params": params,
        "fopt": fval_history[-1],
        "wopt": w,
        "fval_history": fval_history,
        "wopt_history": wopt_history,
        "time_elapsed": elapsed,
        "total_evals": n_iters,
        "evals_per_sec": n_iters / max(elapsed, 1e-9),
    }


# --------------------------------------------------------------------------
# baselines
# --------------------------------------------------------------------------


def run_input(input_audio, target_audio, sample_rate, chain=None, model=None,
              *args, **kwargs):
    """The input, unprocessed."""
    return {"output_audio": input_audio, "time_elapsed": 0.0}


def run_random(input_audio, target_audio, sample_rate, chain: ChainSpec,
               model=None, seed: int = 0, device="cuda", **kwargs):
    """The input rendered at one parameter vector drawn from numpy's
    ``default_rng(seed)``, by the per-candidate renderer."""
    dev = resolve_device(device)
    w = np.random.default_rng(seed).random(chain.num_params)
    t0 = time.time()
    render = build_render_fn(chain, sample_rate, input_audio.shape[1],
                             device=dev)
    y = render(torch.as_tensor(w, dtype=torch.float32),
               torch.as_tensor(input_audio, dtype=torch.float32,
                               device=dev)[0])[None]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"output_audio": y, "param_dict": parameters_to_dict(w, chain),
            "time_elapsed": time.time() - t0}


def run_learned_inference(input_audio, target_audio, sample_rate, system,
                          state, chain=None, model=None, **kwargs):
    """DeepAFx-ST-style learned inference as a benchmark method (reference:
    st_ito/style_transfer.py:281-318): one forward pass of a trained
    ``train.style.StyleTransferSystem`` (``state`` its
    ``StyleTrainState``) predicts the parameters and renders the input,
    on the system's device (default the card); mono input and target are
    duplicated to stereo."""
    dev = system.device
    t0 = time.time()
    x = torch.as_tensor(input_audio, dtype=torch.float32, device=dev)
    y = torch.as_tensor(target_audio, dtype=torch.float32, device=dev)
    if x.shape[1] == 1:
        x = torch.cat([x, x], dim=1)
    if y.shape[1] == 1:
        y = torch.cat([y, y], dim=1)
    with torch.no_grad():
        output_audio, w, _ = system.forward(state.model, x, y,
                                            render_audio=True)
    w = w[0].cpu().numpy()
    return {
        "output_audio": output_audio,
        "params": {f"{i}": float(v) for i, v in enumerate(w)},
        "time_elapsed": time.time() - t0,
    }


def _rb_lufs(sig: torch.Tensor, sample_rate: int) -> torch.Tensor:
    from st_ito_torch.ops.loudness import integrated_loudness

    return integrated_loudness(sig, sample_rate)


def _rb_comp_step(sig: torch.Tensor, threshold_db: float, sample_rate: int):
    """One step of the hill climb: the linked compressor, op by op
    (``fast=False``: no kernel, as the JAX package calls it), at
    ``threshold_db``, peak-normalised to -12 dBFS; and its LUFS."""
    from st_ito_torch.ops.dynamics import compressor

    y = compressor(sig, sample_rate, threshold_db=threshold_db, ratio=3.0,
                   attack_ms=1.0, release_ms=100.0, knee_db=0.5)
    y = y / torch.clamp_min(y.abs().max(), 1e-8) * 10 ** (-12 / 20)
    return y, _rb_lufs(y, sample_rate)


def run_rule_based(input_audio, target_audio, sample_rate, chain=None,
                   model=None, n_fft: int = 16384, n_taps: int = 2048,
                   device="cuda", **kwargs):
    """Matched-EQ FIR, then a compressor-threshold hill climb on the LUFS
    gap to the target: the filter designed and applied with scipy on the
    host, the climb on ``device`` (``ops/loudness.py``, the linked
    compressor of ``ops/dynamics.py``)."""
    import scipy.signal

    dev = resolve_device(device)
    t0 = time.time()

    def host(a):
        return (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                else np.asarray(a))

    input_audio, target_audio = host(input_audio), host(target_audio)
    outs = []
    for b in range(input_audio.shape[0]):
        x = input_audio[b]
        t = target_audio[b]
        x = x / max(np.abs(x).max(), 1e-8) * 10 ** (-12 / 20)
        t = t / max(np.abs(t).max(), 1e-8) * 10 ** (-12 / 20)

        def avg_spec(sig):
            _, _, Z = scipy.signal.stft(sig.mean(axis=0), nperseg=n_fft,
                                        noverlap=n_fft // 2, padded=True)
            return np.abs(Z).mean(axis=-1)

        in_spec = scipy.signal.savgol_filter(avg_spec(x), 1025, 2)
        ref_spec = scipy.signal.savgol_filter(avg_spec(t), 1025, 2)
        response = ref_spec / np.maximum(in_spec, 1e-10)
        response[-1] = 0.0
        freqs = np.linspace(0, 1.0, (n_fft // 2) + 1)
        fir = scipy.signal.firwin2(n_taps, freqs * (sample_rate / 2),
                                   response, fs=sample_rate)
        x_filt = scipy.signal.lfilter(fir, [1.0], x).astype(np.float32)
        x_filt = x_filt / max(np.abs(x_filt).max(), 1e-8) * 10 ** (-12 / 20)

        x_filt = torch.as_tensor(x_filt, device=dev)
        target_lufs = float(_rb_lufs(torch.as_tensor(t, device=dev),
                                     sample_rate))
        x_cur = x_filt
        delta = target_lufs - float(_rb_lufs(x_cur, sample_rate))
        threshold_db = 0.0
        while delta > 0.25 and threshold_db > -80.0:
            x_cur, y_lufs = _rb_comp_step(x_filt, threshold_db, sample_rate)
            delta = target_lufs - float(y_lufs)
            threshold_db -= 2.0
        outs.append(x_cur)
    return {"output_audio": torch.stack(outs),
            "time_elapsed": time.time() - t0}
