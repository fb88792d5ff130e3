"""Style-transfer CLI — port of ``st_ito_tpu/cli/run_optim.py``, the main
entry point:

    python -m st_ito_torch.cli.run_optim input.wav target.wav \\
        --max-iters 300 --popsize 32 --max-length 262144 \\
        [--normalize-stages] [--effect-type {vst,basic}]
        [--algorithm {es,autodiff}] [--device cuda]

Pass ``None`` as target for the synthetic-target self test: a target is
rendered from known parameters and the optimiser must recover it.

The flags are the JAX CLI's, plus ``--device`` (default ``cuda``; the JAX
CLI takes its device from JAX's platform selection): ``--device cpu`` runs
the whole path on the CPU with the kernels' plain versions. ``--effect-type
vst`` (the default) is EQ -> delay -> reverb, the native chain standing in
for the reference's ZamEQ2 -> FlyingDelay -> TAL-Reverb-4; its population
renderer runs K6, then K3 -> K4. ``--staged`` optimises one stage at a
time (``run_staged_es``); ``--savepop`` writes every generation's renders,
ranked, under the run directory; ``--chunked`` is the long-audio mode;
``--dropout`` is the embedding dropout. ``--metric mfcc`` scores by
the MFCC feature metric (``models/registry.py get_mfcc_feature_embeds``)
in place of the AFx-Rep encoder; ``--metric clap`` by LAION-CLAP's
mid/side embeddings (``load_clap_model``: the native tower of
``models/clap_laion.py`` on the device, its weights from a local file or
the local Hugging Face cache only). ``--algorithm autodiff`` is gradient ITO
(``run_autodiff``, Adam at lr 1e-2 for ``--max-iters`` steps) through the
51-parameter differentiable processor (``proc.py``), whose synthetic
target is the JAX CLI's. ``--use-gpu`` and ``--parallel`` are
accepted and do nothing: the population always renders in parallel on the
device. ``--num-devices N`` above 1 splits the ES population over N ranks
(``parallel.make_mesh(N, "pop")``): the CLI starts them itself (one
process each, NCCL with one card a rank, or gloo ranks with ``--device
cpu``), or, started by ``torchrun``, joins torchrun's group of N; every
rank computes the same result and rank 0 writes the outputs. As in the
JAX CLI, gradient ITO does not use the mesh. The convergence plot is best
effort (it needs matplotlib).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch


def build_chain(effect_type: str, algorithm: str, with_bypass: bool = False):
    from st_ito_torch.chain import (ChainSpec, basic_chain, basic_delay,
                                    basic_parametric_eq, basic_reverb)

    if algorithm == "autodiff":
        return None  # 51-param complex processor, no chain spec
    if effect_type == "basic":
        return basic_chain(with_bypass=with_bypass)
    # "vst": native chain standing in for ZamEQ2 -> FlyingDelay -> TAL-Reverb-4
    return ChainSpec(
        stages=(basic_parametric_eq(), basic_delay(), basic_reverb()),
        with_bypass=with_bypass,
    )


def synthetic_target_params(chain) -> np.ndarray:
    """Stylized target parameters (bass cut, bright shelf, compression,
    moderate reverb): the recoverable self-test target."""
    w = np.full(chain.num_params, 0.5)
    for stage, start, end in chain.stage_slices():
        off = start + (1 if chain.with_bypass else 0)
        if stage.effect == "parametric_eq":
            w[off:off + 3] = [0.1, 0.5, 0.2]      # low shelf cut
            w[off + 15:off + 18] = [0.7, 0.5, 0.2]  # high shelf boost
        elif stage.effect == "compressor":
            w[off:off + 4] = [0.8, 0.3, 0.1, 0.1]
        elif stage.effect == "distortion":
            w[off:off + 2] = [0.5, 0.5]
        elif stage.effect == "delay":
            w[off:off + 3] = [0.2, 0.2, 0.15]
        elif stage.effect == "reverb":
            w[off:off + 4] = [0.6, 0.4, 0.3, 0.7]
        if chain.with_bypass:
            w[start] = 0.0
    return w


def synthetic_autodiff_target_params() -> np.ndarray:
    """The 51-parameter processor's self-test target (bass cut, bright
    shelf, compression), the JAX CLI's."""
    from st_ito_torch import proc

    w = np.full(proc.NUM_COMPLEX_PARAMS, 0.5, np.float32)
    w[:3] = [0.1, 0.5, 0.2]
    w[15:18] = [0.7, 0.5, 0.2]
    w[18:24] = [0.8, 0.3, 0.1, 0.1, 0.5, 0.1]
    return w


def _rank_main(argv):
    """One rank of ``--num-devices``, in a process ``parallel.launch``
    started."""
    main(argv)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("input", type=str)
    parser.add_argument("target", type=str)
    parser.add_argument("--max-iters", type=int, default=300)
    parser.add_argument("--popsize", type=int, default=32)
    parser.add_argument("--max-length", type=int, default=262144)
    parser.add_argument("--staged", action="store_true")
    parser.add_argument("--savepop", action="store_true")
    parser.add_argument("--normalize-stages", action="store_true")
    parser.add_argument("--use-gpu", action="store_true")
    parser.add_argument("--parallel", action="store_true")
    parser.add_argument("--effect-type", type=str, default="vst",
                        choices=["vst", "basic"])
    parser.add_argument("--algorithm", type=str, default="es",
                        choices=["es", "autodiff"])
    parser.add_argument("--dropout", type=float, default=0.0)
    parser.add_argument("--metric", type=str, default="param",
                        choices=["param", "clap", "mfcc"])
    parser.add_argument("--sigma0", type=float, default=0.33)
    parser.add_argument("--chunked", action="store_true",
                        help="long-audio mode: render the whole input, "
                             "embed it in chunks of 262144 samples")
    parser.add_argument("--gens-per-dispatch", type=int, default=1,
                        help="generations per device block of the CMA-ES")
    parser.add_argument("--pop-microbatch", type=int, default=None,
                        help="evaluate the population in sub-batches of "
                             "this size")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--output-dir", type=str, default="output/optim")
    parser.add_argument("--allow-random-model", action="store_true",
                        help="use a randomly initialized encoder when no "
                             "checkpoint is available (offline testing)")
    parser.add_argument("--num-devices", type=int, default=0,
                        help="shard the population over this many ranks, "
                             "one device each")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default) or cpu")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser.parse_args(argv)

    import torch.distributed as dist

    from st_ito_torch.parallel import launch, make_mesh
    from st_ito_torch.parallel.mesh import default_backend
    from st_ito_torch.utils import resolve_device

    mesh = None
    if args.num_devices > 1:
        resolve_device(args.device)
        if not dist.is_initialized() and "WORLD_SIZE" not in os.environ:
            from st_ito_torch.cli import run_optim

            launch(run_optim._rank_main, (argv,), args.num_devices,
                   default_backend(args.device))
            return None
        mesh = make_mesh(args.num_devices, "pop", device=args.device)
    lead = mesh is None or mesh.rank == 0

    from st_ito_torch import proc
    from st_ito_torch.chain import build_render_fn
    from st_ito_torch.ito import run_autodiff, run_es, run_staged_es
    from st_ito_torch.models.registry import (get_mfcc_feature_embeds,
                                              get_param_embeds,
                                              load_mfcc_feature_extractor,
                                              load_param_model)
    from st_ito_torch.ops.resample import resample
    from st_ito_torch.utils import load_audio, save_audio

    dev = mesh.device if mesh is not None else resolve_device(args.device)
    sample_rate = 48000
    if lead:
        os.makedirs(args.output_dir, exist_ok=True)

    chain = build_chain(args.effect_type, args.algorithm)

    # ---- load audio ----
    input_np, input_sr = load_audio(args.input)
    input_name = os.path.basename(args.input).replace(".wav", "")
    input_audio = torch.from_numpy(input_np).to(dev)
    if input_sr != sample_rate:
        input_audio = resample(input_audio, input_sr, sample_rate)

    # ---- metric ----
    if args.metric == "mfcc":
        model = load_mfcc_feature_extractor()
        embed_func = get_mfcc_feature_embeds
    elif args.metric == "clap":
        from st_ito_torch.models.clap_laion import \
            get_clap_laion_embeds_midside
        from st_ito_torch.models.registry import load_clap_model

        model = load_clap_model(device=dev)
        embed_func = get_clap_laion_embeds_midside
    else:
        model = load_param_model(allow_random=args.allow_random_model,
                                 device=dev)
        embed_func = get_param_embeds

    # ---- target ----
    if args.target in (None, "None", "none"):
        if args.algorithm == "autodiff":
            w_target = torch.from_numpy(synthetic_autodiff_target_params())
            target_audio = proc.apply_complex_autodiff_processor(
                input_audio[None], w_target.to(dev)[None], sample_rate)[0]
        else:
            w_target = synthetic_target_params(chain)
            render = build_render_fn(chain, sample_rate,
                                     input_audio.shape[0], device=dev)
            target_audio = render(
                torch.as_tensor(w_target, dtype=torch.float32), input_audio)
        target_name = "synthetic_target"
    else:
        target_np, target_sr = load_audio(args.target)
        target_audio = torch.from_numpy(target_np).to(dev)
        if target_sr != sample_rate:
            target_audio = resample(target_audio, target_sr, sample_rate)
        target_name = os.path.basename(args.target).replace(".wav", "")

    input_audio = input_audio[:, :args.max_length]
    target_audio = target_audio[:, :args.max_length]

    run_name = f"{input_name}_to_{target_name}_{args.algorithm}"
    run_dir = os.path.join(args.output_dir, run_name)
    if lead:
        os.makedirs(run_dir, exist_ok=True)
        save_audio(os.path.join(run_dir, "input_audio.wav"), input_audio,
                   sample_rate)
        t = target_audio.cpu().numpy()
        save_audio(os.path.join(run_dir, "target_audio.wav"),
                   t / max(np.abs(t).max(), 1e-8), sample_rate)

    # ---- run ----
    sigma0 = args.sigma0
    if args.algorithm == "autodiff":
        result = run_autodiff(
            input_audio[None], target_audio[None], sample_rate, model,
            embed_func=embed_func, lr=1e-2, n_iters=args.max_iters,
            dropout=args.dropout, seed=args.seed, device=dev)
    else:
        es_func = run_staged_es if args.staged else run_es
        result = es_func(
            input_audio[None], target_audio[None], sample_rate, chain,
            model, embed_func=embed_func, max_iters=args.max_iters,
            popsize=args.popsize, find_w0=True, sigma0=sigma0,
            distance="cosine", dropout=args.dropout, savepop=args.savepop,
            normalize_stages=args.normalize_stages, run_dir=run_dir,
            seed=args.seed, mesh=mesh, chunked=args.chunked,
            gens_per_dispatch=args.gens_per_dispatch,
            pop_microbatch=args.pop_microbatch, device=dev)
    if mesh is not None:
        mesh.close()
    if not lead:
        return result

    # ---- save results ----
    out = result["output_audio"][0].cpu().numpy()
    out = out / max(np.abs(out).max(), 1e-8)
    save_audio(os.path.join(run_dir, f"output_audio_sigma={sigma0:0.2f}.wav"),
               out, sample_rate)

    with open(os.path.join(run_dir, f"parameters_sigma={sigma0:0.2f}.json"),
              "w") as f:
        json.dump(result["params"], f, indent=4, default=float)

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(6, 4))
        ax.plot(result["fval_history"], label=f"sigma0={sigma0:0.2f}")
        ax.set_xlabel("Iteration")
        ax.set_ylabel("Distance")
        ax.legend()
        fig.savefig(os.path.join(run_dir, "plot.png"), dpi=150)
        plt.close(fig)
    except Exception as e:  # plotting is best-effort
        print(f"plot skipped: {e}", file=sys.stderr)

    summary = {
        "run_dir": run_dir,
        "fopt": float(result.get("fopt", np.nan)),
        "time_elapsed": result.get("time_elapsed"),
        "total_evals": result.get("total_evals"),
        "evals_per_sec": result.get("evals_per_sec"),
    }
    print(json.dumps(summary, indent=2, default=float))
    return result


if __name__ == "__main__":
    main()
