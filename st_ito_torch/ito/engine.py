"""CMA-ES inference-time optimisation — port of ``st_ito_tpu/ito/engine.py``'s
``_embedding_distance``, ``make_fitness_fn`` and ``run_es`` (with its
device-resident block loop, ``_run_es_device_loop``).

Per generation: ``cma_ask`` draws the population on the device; the
population renderer renders every candidate on the shared input with the
chain's kernels (the basic chain: K1, then the fused LTI group by
``fft_mode``: K3 -> K4 for "mega2", which "auto" picks, K5 -> K2 -> K4 for
"mega", torch.fft -> K9 -> torch.fft for "mx", K10 -> K9 -> K10 for
"fused"; the CLI's vst chain: K6, then K3 -> K4; the style chain: K6, then
K8 inside the multiband compressor and the limiter; a lone unlinked
compressor: K7); the Cnn14 embeds the renders; the fitness is
the negative cosine against the target embeddings; ``cma_tell`` updates the
search state. Statistics stay on the device and reach the host once per
``gens_per_dispatch`` block.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from st_ito_torch.chain.executor import (build_batched_render_fn,
                                         build_render_fn, parameters_to_dict)
from st_ito_torch.chain.params import ChainSpec
from st_ito_torch.ito import device_es
from st_ito_torch.models.registry import get_param_embeds
from st_ito_torch.utils import phase_timer, resolve_device


def _embedding_distance(output_embeds, target_embeds):
    """(heads, B) -cosine(out, target) per head."""
    dists = []
    for name, out in output_embeds.items():
        tgt = target_embeds[name]
        dists.append(-torch.sum(out * tgt, dim=-1) / (
            torch.linalg.norm(out, dim=-1) * torch.linalg.norm(tgt, dim=-1)
            + 1e-12))
    return torch.stack(dists, dim=0)


def _resolve_fitness_dtype(compute_dtype: str | None, device) -> str:
    """bfloat16 for the conv stack on the card, float32 elsewhere."""
    if compute_dtype is not None:
        return compute_dtype
    return "bfloat16" if device.type == "cuda" else "float32"


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported to st_ito_torch yet "
                              f"(ROADMAP §1 item {item})")


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
    bfloat16 on the card and float32 on the CPU. ``pop_microbatch``: score
    the population in sub-batches of this size when it divides the
    population (not with return_audio). ``fft_mode``: how the renderer
    applies the fused LTI group (``build_batched_render_fn``: "mega2",
    "mega", "mx" or "fused"; "auto" is "mega2"). The renderer's output
    normalisation is skipped when the embed
    peak-normalises its input. ``normalize_stages`` renders each candidate
    through the per-candidate ``build_render_fn`` instead (plain PyTorch, no
    kernel)."""
    dev = resolve_device(device)
    if content_model is not None:
        _not_ported("a content model", "6")
    if dropout > 0.0:
        _not_ported("embedding dropout", "6")
    if mesh is not None:
        _not_ported("a device mesh", "13")
    if getattr(embed_func, "host_side", False):
        _not_ported("a host-side metric", "11")
    compute_dtype = _resolve_fitness_dtype(compute_dtype, dev)
    if model.config.compute_dtype != compute_dtype:
        model = dataclasses.replace(model, config=dataclasses.replace(
            model.config, compute_dtype=compute_dtype))
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
                     and getattr(embed_func, "peak_normalizes_input", False))
        render = build_batched_render_fn(
            chain, sample_rate, num_channels, fast=renderer_fast,
            fft_mode=fft_mode, fft_precision=fft_precision,
            peak_normalize_output=not skip_norm, max_lti_pad=max_lti_pad,
            device=dev)

    def score(W, x, target_embeds):
        Y = render(W, x)
        with phase_timer.span("embed", dev):
            out = embed_func(Y, model, sample_rate)
            fvals = torch.mean(_embedding_distance(out, target_embeds), dim=0)
        return fvals, out, Y

    def fitness(W, x, target_embeds, target_content_embeds=None, rng=None):
        del target_content_embeds, rng  # no content model, no dropout
        W = torch.as_tensor(W, dtype=torch.float32, device=dev)
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        if return_audio:
            return score(W, x, target_embeds)
        mb = pop_microbatch
        if mb and W.shape[0] > mb and W.shape[0] % mb == 0:
            return torch.cat([score(Wi, x, target_embeds)[0]
                              for Wi in W.split(mb)])
        return score(W, x, target_embeds)[0]

    return fitness


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

    Every generation runs the device-resident CMA-ES (``device_es``),
    ``gens_per_dispatch`` generations per block with one host fetch of
    their statistics per block; at gens_per_dispatch=1 that is a block of
    one, where the JAX package switches to its host CMA-ES
    (``ito/cmaes.py``, ROADMAP §1 item 6). ``find_w0`` draws the same
    ``W_init`` as the JAX package: numpy's ``default_rng(seed)``.

    ``output_audio`` is rendered per candidate (``build_render_fn``), as in
    the JAX package: stage by stage, the delay's tail truncated at the
    buffer end before the reverb, where the population renderer's fused
    group lets it through. Its time is outside ``time_elapsed``."""
    dev = resolve_device(device)
    if savepop:
        _not_ported("savepop", "6")
    if chunked:
        _not_ported("chunked (long-audio) mode", "6")
    if es_state_path is not None:
        _not_ported("es_state_path (ES snapshots)", "6")
    if opt_slice is not None or w_template is not None:
        _not_ported("opt_slice (staged ES)", "6")
    if distance != "cosine":
        raise ValueError(f"distance={distance!r}: only 'cosine' exists")
    del parallel, run_dir  # parallel always; nothing is written
    rng = np.random.default_rng(seed)
    generator = torch.Generator(device=dev).manual_seed(seed)
    crop_generator = torch.Generator().manual_seed(seed)

    def peak_norm(a):
        a = torch.as_tensor(a, dtype=torch.float32, device=dev)
        return a / torch.clamp_min(a.abs().max(), 1e-8)

    input_audio = peak_norm(input_audio)
    target_audio = peak_norm(target_audio)
    target_embed = embed_func(target_audio, model, sample_rate)

    num_params = chain.num_params
    x_full = input_audio[0]  # (C, T)
    T = x_full.shape[-1]
    eval_len = min(T, crop_len)

    fitness = make_fitness_fn(
        chain, model, sample_rate, x_full.shape[0], embed_func,
        content_model, content_embed_func, dropout, normalize_stages, mesh,
        compute_dtype=fitness_dtype, fft_mode=fft_mode,
        pop_microbatch=pop_microbatch, device=dev)

    t_start = time.time()
    total_evals = 0
    if find_w0:
        W_init = rng.random((popsize, num_params))
        start = 0
        if random_crop and (T - crop_len) > 16384:
            start = int(rng.integers(16384, T - crop_len))
        fvals = fitness(W_init, x_full[..., start:start + eval_len],
                        target_embed)
        total_evals += popsize
        w0 = W_init[int(torch.argmin(fvals))]
    elif w0 is None:
        w0 = np.full(num_params, 0.5)
    else:
        w0 = np.asarray(w0, np.float64)

    fval_history: list[float] = []
    wopt_history: list[np.ndarray] = []
    wopt, fopt, total_evals = _run_es_device_loop(
        fitness, num_params, x_full, target_embed, w0, sigma0, popsize,
        max_iters, gens_per_dispatch, random_crop, crop_len, eval_len,
        early_stop_patience, early_stop_threshold, verbose, generator,
        crop_generator, total_evals, fval_history, wopt_history, dev)
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


def _run_es_device_loop(fitness, opt_width, x_full, target_embed, w0, sigma0,
                        popsize, max_iters, gens_per_dispatch, random_crop,
                        crop_len, eval_len, early_stop_patience,
                        early_stop_threshold, verbose, generator,
                        crop_generator, total_evals, fval_history,
                        wopt_history, device):
    """k generations per block (see run_es). Appends to fval_history and
    wopt_history in place; returns (wopt, fopt, total_evals)."""
    consts = device_es.cma_consts(opt_width, popsize, device)
    state = device_es.cma_init(w0, sigma0, device)
    T = x_full.shape[-1]
    if random_crop and (T - crop_len) > 16384:
        x_eval, blk_crop = x_full, crop_len
    else:
        x_eval, blk_crop = x_full[..., :eval_len], None
    runner = device_es.make_block_runner(fitness, consts, crop_len=blk_crop)

    stopped = False
    done = 0
    iters_without_improvement = 0
    while done < max_iters and not stopped:
        k = min(gens_per_dispatch, max_iters - done)
        state, stats = runner(state, x_eval, target_embed, k, generator,
                              crop_generator)
        packed = stats.cpu().numpy()  # the block's one host fetch
        gen_min, best_f, best_x = packed[:, 0], packed[:, 1], packed[:, 2:]
        for j in range(k):
            prev_best = min(fval_history) if fval_history else None
            total_evals += popsize
            fval_history.append(float(best_f[j]))
            wopt_history.append(best_x[j].astype(np.float64))
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

    wopt = (wopt_history[-1] if wopt_history
            else np.asarray(w0, np.float64))
    fopt = fval_history[-1] if fval_history else float("inf")
    return wopt, fopt, total_evals
