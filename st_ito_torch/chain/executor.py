"""The two renderers — port of ``st_ito_tpu/chain/executor.py``.

``build_render_fn`` (``:43``) renders one candidate stage by stage through
each stage's ``process_fn`` in plain PyTorch, truncating to the buffer at
every stage boundary.

``build_batched_render_fn`` (``:85``) renders a population with the plan the
JAX package runs on its accelerator (``executor.py:150-195``, ``:206-327``):

- an EQ -> compressor (-> distortion) head fused into ONE pass of the K1
  kernel (``ops/kernels/eqcomp.py``);
- any other EQ ("fast") as one pass of the K6 kernel
  (``ops/kernels/scan.py``), its bypass blended in-kernel;
- consecutive LTI stages (delay, reverb, gain, widener) fused into one group
  (one group per stage with ``fuse_lti=False``) with a guard of the full T
  for feedback tails, so the FFT size is next_pow2(T + T), applied by
  ``fft_mode``: "mega2" as K3 -> K4, "mega" as K5 -> K2 -> K4
  (``ops/kernels/mega_fft.py``), "mx" as torch.fft -> K9 -> torch.fft and
  "fused" as K10 -> K9 -> K10 (``ops/lti.py``); "xla", and a mono group in
  any mode, compose the stages' responses (``chain/responses.py
  compose_responses``) and apply them between ``torch.fft.rfft`` and
  ``irfft``;
- every other stage ("nl": compressor, distortion, limiter, multiband
  compressor, noise gate, chorus, phaser) through its batched function
  (``chain/responses.py NL_BATCHED``): the unlinked compressor as one pass
  of K7, the linked compressors' and the noise gate's detector in K8, each
  of the phaser's six allpasses as one pass of K11, the chorus as gathers
  in plain PyTorch;
- peak normalisation of the output.

A population-shared (C, T) input is streamed into a leading K1 or K6 pass
and never broadcast to (B, C, T); before any other first stage it is
broadcast, as in the JAX package (the JAX K6 has no shared mode, so there
the lone EQ reads the broadcast; the output is the same).

``fast=False`` is the differentiable renderer, the JAX package's plan off
its accelerator (``executor.py:134-161``): no kernel on any device. The EQ
joins the LTI groups through its response, every LTI group takes the
per-stage response path between ``torch.fft.rfft`` and ``irfft`` (where
the JAX package applies a scalar or monomix group through its four-step FFT,
``ops/mxfft.py``, in the mega and mx modes), and every "nl" stage runs op by
op: the compressors' and the gate's detector as the doubling scans of
``ops/dynamics.py ballistics_parallel``, the phaser's allpasses as
``ops/iir.py linear_recurrence``. All of it is plain PyTorch under autograd.

Semantics kept from the JAX package: the bypass rule (a stage is active when
``W[:, start] <= 0.5``), the mono -> stereo promotion before the first stereo
stage, and the "tail-continuous" fused LTI group (the delay's tail past the
buffer end feeds the reverb).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from st_ito_torch.chain.params import ChainSpec, StageSpec
from st_ito_torch.chain.responses import (NL_BATCHED, apply_response,
                                          bypass_blend, compose_responses,
                                          eq_comp_fast_batched,
                                          eq_fast_batched)
from st_ito_torch.chain.rp_responses import RP_BUNDLES
from st_ito_torch.ops.iir import next_pow2
from st_ito_torch.ops.kernels import mega_fft
from st_ito_torch.ops.kernels.packed_response import rp_tables
from st_ito_torch.ops.lti import packed_lti_apply_rp
from st_ito_torch.utils import resolve_device


def stage_params(stage: StageSpec, W: torch.Tensor, start: int,
                 bypass_off: int) -> dict:
    """name -> (B,) denormalized values of one stage, fixed ones pinned."""
    out = {}
    for j, p in enumerate(stage.params):
        raw = W[:, start + bypass_off + j]
        if p.name in stage.fixed_parameters:
            raw = torch.full_like(raw, stage.fixed_parameters[p.name])
        out[p.name] = p.denormalize(raw)
    return out


def build_render_fn(chain: ChainSpec, sample_rate: int, num_channels: int,
                    normalize_stages: bool = False,
                    peak_normalize_output: bool = True, device="cuda"):
    """Returns render(w (P,), x (num_channels, T)) -> y (C_out, T) on
    ``device`` (default the card): the per-candidate renderer, every stage
    through its ``process_fn`` with the buffer truncated to T after each.

    A bypassed stage (``w[start] > 0.5``) passes its input through;
    ``normalize_stages`` peak-normalises after every stage. The output has
    2 channels iff the input is stereo or any stage is."""
    del num_channels  # channel promotion is resolved from x, as in JAX
    dev = resolve_device(device)
    slices = chain.stage_slices()
    bypass_off = 1 if chain.with_bypass else 0

    def peak_norm(y):
        return y / torch.clamp_min(y.abs().max(), 1e-8)

    def render(w, x) -> torch.Tensor:
        w = torch.as_tensor(w, dtype=torch.float32, device=dev)
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        for stage, start, _ in slices:
            params = {k: v[0] for k, v in
                      stage_params(stage, w[None], start, bypass_off).items()}
            if stage.num_channels == 2 and x.shape[0] == 1:
                x = torch.cat([x, x], dim=0)
            y = stage.process_fn(x, params, sample_rate)
            if chain.with_bypass:
                y = torch.where(w[start] <= 0.5, y, x)
            x = peak_norm(y) if normalize_stages else y
        return peak_norm(x) if peak_normalize_output else x

    return render


def _plan(chain: ChainSpec, fuse_lti: bool = True,
          fast: bool = True) -> list[tuple[str, list[int]]]:
    """Group the chain's stages as the JAX package's TPU plan does (with
    ``fast``; without it, as its plan off the TPU): the EQ is "fast" (else
    a stage with a response), consecutive stages with a response form "lti"
    groups (one per stage without ``fuse_lti``), the rest are "nl"; with
    ``fast`` an EQ -> compressor (-> distortion) run merges into one
    "eqcomp" head. Raises for an "nl" stage with no batched function."""
    slices = chain.stage_slices()
    plan: list[tuple[str, list[int]]] = []
    for i, (stage, _, _) in enumerate(slices):
        if fast and stage.effect == "parametric_eq":
            plan.append(("fast", [i]))
        elif stage.response_fn is not None:
            if fuse_lti and plan and plan[-1][0] == "lti":
                plan[-1][1].append(i)
            else:
                plan.append(("lti", [i]))
        else:
            plan.append(("nl", [i]))

    merged: list[tuple[str, list[int]]] = []
    for kind, idxs in plan:
        effect = slices[idxs[0]][0].effect
        if (merged and merged[-1][0] == "fast" and kind == "nl"
                and effect == "compressor"):
            merged[-1] = ("eqcomp", merged[-1][1] + idxs)
        elif (merged and merged[-1][0] == "eqcomp"
                and len(merged[-1][1]) == 2 and kind == "nl"
                and effect == "distortion"):
            merged[-1] = ("eqcomp", merged[-1][1] + idxs)
        else:
            merged.append((kind, idxs))

    for kind, idxs in merged:
        effect = slices[idxs[0]][0].effect
        if kind == "nl" and effect not in NL_BATCHED:
            raise NotImplementedError(
                f"stage {slices[idxs[0]][0].name!r} ({effect}) has no batched "
                f"function: the population renderer runs the effects of "
                f"EFFECT_REGISTRY")
    return merged


def build_batched_render_fn(
    chain: ChainSpec,
    sample_rate: int,
    num_channels: int,
    fast: bool = True,
    peak_normalize_output: bool = True,
    fuse_lti: bool = True,
    fft_mode: str = "auto",
    fft_precision: str = "high",
    max_lti_pad: int | None = None,
    out_rows_hop: int | None = None,
    device="cuda",
):
    """The population renderer: render(W (B, P), x) -> (B, C_out, T), with
    x either (C, T) shared across candidates or (B, C, T) per-candidate.

    Runs on ``device`` (default the card). ``fast=False`` renders without
    any kernel, differentiably (module docstring); ``fft_mode`` has no
    effect then. ``fft_mode`` picks how the fused
    LTI group is applied: "mega2" (K3 -> K4), "mega" (K5 -> K2 -> K4), "mx"
    (torch.fft -> K9 -> torch.fft), "fused" (K10 -> K9 -> K10; "mx3" is
    its JAX alias) or "xla" (the per-stage responses composed and applied
    between ``torch.fft.rfft`` and ``irfft``; the EQ stays on K6, as in the
    JAX package's TPU plan). "auto", the default, is "mega2" on any device
    (on the CPU the kernels' plain versions run). ``fuse_lti=False`` makes
    each LTI stage a group of its own, applied by the same dispatch: each
    truncates to the buffer, as the per-candidate renderer does. A mono
    group takes the response path in every mode. A shape that
    ``mega_fft.supported(n, T)`` rejects (T not a multiple of n2, or n below
    2^14) takes the "mx" path in either mega mode, and one that
    ``fused_fft.supported(n, T)`` rejects (the same rule) takes it in
    "fused", as in the JAX package: a shape dispatch, visible in the
    kernels' launch counters. The JAX gate
    ``B % 8 == 0`` is a TPU tile rule and is not kept: any B takes the mega
    path. Every transform is float32, at least as precise as
    ``fft_precision="high"``; the reduced-precision modes are TPU devices
    (bf16 dot passes) and are not ported."""
    if fft_mode == "auto":
        fft_mode = "mega2" if fast else "xla"
    if fft_mode not in ("mega2", "mega", "mx", "fused", "mx3", "xla"):
        raise ValueError(
            f"fft_mode={fft_mode!r}: 'auto', 'mega2', 'mega', 'mx', "
            f"'fused' ('mx3') or 'xla'")
    if fft_precision not in ("high", "highest"):
        raise NotImplementedError(
            f"fft_precision={fft_precision!r}: reduced-precision FFTs are "
            f"not ported (ROADMAP §2); every transform is float32")
    if out_rows_hop is not None:
        raise NotImplementedError(
            "out_rows_hop: the hop-blocked rows form is a TPU layout device "
            "that the port does not carry (ROADMAP north star)")
    del num_channels  # channel promotion is resolved from x, as in JAX
    dev = resolve_device(device)
    slices = chain.stage_slices()
    bypass_off = 1 if chain.with_bypass else 0
    plan = _plan(chain, fuse_lti, fast)

    def active_mask(W, start):
        return (W[:, start] <= 0.5).to(torch.float32)

    def response_group(x, stages, W, n):
        """The group's stages' responses, bypass-blended and composed, on
        the size-n rfft grid, applied to x (B, C, T)."""
        F = n // 2 + 1
        omega = torch.linspace(0.0, math.pi, F, dtype=torch.float32,
                               device=dev)
        kind, H = "scalar", None
        for stage, start, _ in stages:
            k, Hs = stage.response_fn(
                stage_params(stage, W, start, bypass_off), omega,
                sample_rate, x.shape[1])
            if chain.with_bypass:
                Hs = bypass_blend(k, Hs, W[:, start] <= 0.5)
            kind, H = compose_responses(kind, H, k, Hs, F)
        X = torch.fft.rfft(x, n=n, dim=-1)
        Y = apply_response(kind, H, X)
        return torch.fft.irfft(Y, n=n, dim=-1)[..., :x.shape[-1]].to(x.dtype)

    def render(W, x) -> torch.Tensor:
        W = torch.as_tensor(W, dtype=torch.float32, device=dev)
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        B = W.shape[0]
        shared = x.ndim == 2
        if shared and plan[0][0] not in ("eqcomp", "fast"):
            x = x[None].expand((B,) + tuple(x.shape))
            shared = False
        T = x.shape[-1]

        for kind, idxs in plan:
            stages = [slices[i] for i in idxs]
            ch_axis = 0 if shared else 1
            if (any(s.num_channels == 2 for s, _, _ in stages)
                    and x.shape[ch_axis] == 1):
                x = torch.cat([x, x], dim=ch_axis)

            if kind == "eqcomp":
                (eq_stage, eq_start, _), (c_stage, c_start, _) = stages[:2]
                p_eq = stage_params(eq_stage, W, eq_start, bypass_off)
                p_c = stage_params(c_stage, W, c_start, bypass_off)
                p_d = a_eq = a_c = a_d = None
                if len(stages) == 3:  # trailing distortion absorbed
                    d_stage, d_start, _ = stages[2]
                    p_d = stage_params(d_stage, W, d_start, bypass_off)
                if chain.with_bypass:
                    a_eq = active_mask(W, eq_start)
                    a_c = active_mask(W, c_start)
                    if p_d is not None:
                        a_d = active_mask(W, d_start)
                x = eq_comp_fast_batched(
                    x, p_eq, p_c, sample_rate, active_eq=a_eq,
                    active_comp=a_c, p_dist=p_d, active_dist=a_d,
                    shared_B=B if shared else None)
                shared = False
                continue

            if kind in ("fast", "nl"):
                stage, start, _ = stages[0]
                params = stage_params(stage, W, start, bypass_off)
                active = active_mask(W, start) if chain.with_bypass else None
                if kind == "fast":
                    x = eq_fast_batched(x, params, sample_rate,
                                        active=active,
                                        shared_B=B if shared else None)
                    shared = False
                    continue
                fn = NL_BATCHED[stage.effect]
                if getattr(fn, "supports_active", False):
                    x = fn(x, params, sample_rate, fast, active=active)
                    continue
                y = fn(x, params, sample_rate, fast)
                if active is not None:
                    y = torch.where(active[:, None, None] > 0.5, y, x)
                x = y
                continue

            # ---- fused LTI group ----
            pad = 0
            for stage, _, _ in stages:
                pad = max(pad, T if stage.pad < 0 else stage.pad)
            if max_lti_pad is not None:
                pad = min(pad, max_lti_pad)
            n = next_pow2(T + pad)
            if (not fast or fft_mode == "xla" or x.shape[1] != 2
                    or any(s.effect not in RP_BUNDLES for s, _, _ in stages)):
                # the per-stage response path: the differentiable one, and
                # the rp kernels are stereo-only, as in the JAX package
                x = response_group(x, stages, W, n)
                continue
            rp_stages = [
                (stage.effect, stage_params(stage, W, start, bypass_off),
                 active_mask(W, start) if chain.with_bypass else None)
                for stage, start, _ in stages]
            if fft_mode == "mega2" and mega_fft.supported(n, T):
                x = mega_fft.packed_lti_apply_mega2(x.contiguous(), rp_stages,
                                                    n, sample_rate)
            elif fft_mode == "mega" and mega_fft.supported(n, T):
                x = mega_fft.packed_lti_apply_mega(x.contiguous(), rp_stages,
                                                   n, sample_rate)
            else:
                x = packed_lti_apply_rp(
                    x, rp_stages, n,
                    rp_tables([s.effect for s, _, _ in stages], sample_rate,
                              n, dev),
                    fft_impl="mx" if fft_mode in ("mega2", "mega")
                    else fft_mode)

        if peak_normalize_output:
            peak = torch.amax(x.abs(), dim=(-2, -1), keepdim=True)
            x = x / torch.clamp_min(peak, 1e-8)
        return x

    return render


def output_channels(chain: ChainSpec, in_channels: int) -> int:
    if in_channels == 2:
        return 2
    return 2 if any(s.num_channels == 2 for s in chain.stages) else 1


def parameters_to_dict(w, chain: ChainSpec) -> dict:
    """Flat raw vector -> nested {stage: {param: physical value}} dict,
    bypass reported raw."""
    w = (w.detach().cpu().numpy() if isinstance(w, torch.Tensor)
         else np.asarray(w))
    out = {}
    for stage, start, _ in chain.stage_slices():
        d = {}
        offset = start
        if chain.with_bypass:
            d["our_bypass"] = float(w[start])
            offset += 1
        for i, p in enumerate(stage.params):
            raw = w[offset + i]
            if p.name in stage.fixed_parameters:
                raw = stage.fixed_parameters[p.name]
            d[p.name] = float(p.denormalize(raw))
        out[stage.name] = d
    return out
