#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``st_ito_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--record PATH]
                          [--phases k1,k9,fft,scan,main,style,comp,fx,cli,
                                    mfcc,long,multitrack,dtype,autodiff,
                                    nofast,eval,pst,clap,train,mesh]

Phases, in order; any failure raises and the script exits non-zero:

1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build every CUDA kernel of the main path from ``st_ito_torch/csrc``
   (one nvcc per source, all started together);
3. ``k1``: K1 (fused EQ -> compressor -> distortion scan, in chunks of T)
   against its plain PyTorch version on the card, mixed bypass throughout:
   B=37, stereo, T=20011 (ragged lane blocks, tiles and chunks), shared and
   per-candidate input, and B=64, stereo, T=65536; then the main path's
   shape, B=512, stereo, T=262144, shared input, the kernel run over the
   whole of T and its first 65536 output samples held against the plain
   runs on the input's first 65536 (the scan is causal); each also against
   a float64 run of the plain version; then K1's time there;
4. ``k9``: K9 (fused delay + reverb response and packed apply) against its
   plain version, fractional delays and mixed bypass: n=2^19 at B=100 (a
   ragged candidate chunk) and at the main path's B=512; then its time;
5. ``fft``: K5, K4, K2 and K3 (the packed FFT pair, the pitched response
   kernel and the forward FFT with the response as its epilogue) each
   against its plain version (torch.fft plus glue), B=37 at n=2^14
   (n1=n2=128) and n=2^15 (n1=256, n2=128) with T=n/2 and T<n/2, K4 with
   NaN written into every bin it must not read, and K4 alone so at B=1, 2,
   9 and 10 (its scheduler below the lag between a candidate's passes, and
   its ring of 9 slots filled and taken again); K3 also against K5 -> K2;
   K3, K2 and K9 on the delay's comb resonances (whole delays, the top
   feedback, fully wet) at n=2^14, B=37 and n=2^19, B=64; then at the
   headline n=2^19, B=512 in full; the groups K3 -> K4,
   K5 -> K2 -> K4 and K10 -> K9 -> K10 against the mx path there; K10 (the
   planar complex DFT of the fused path) against its plain version
   (torch.fft) at B=37, forward with a guard band and inverse with an
   out_len that is not a multiple of n1, then at the headline forward
   (in_len 2^18 -> 2^19 bins) and inverse (2^19 -> out_len 2^18); each
   kernel's time, and cuFFT's for the same transforms;
6. ``scan``: K6 (the lone biquad-cascade EQ), K7 (the whole unlinked
   compressor), K8 (the lone compressor ballistics) and K11 (the linear
   recurrence), all four chunked scans, against their plain versions:
   74 lanes (B=37, stereo; K8 37 lanes), T=20011, K6 with mixed bypass on
   a shared and a per-candidate input, K7 with and without its bypass row;
   then each at its headline shape: K6 at the CLI's 1024 lanes x 262144 on
   the shared input (its first 65536 output samples held against the
   plain runs on the input's first 65536), and in full K7 at the compressor-led chain's 1024 lanes
   x 262144 with and without the bypass row, K8 at the style chain's 512
   lanes x 262144, K11 at 1024 lanes x 262144; each also against a
   float64 run of its plain version (K6's, K7's and K8's at the headline
   made in a spawned process beside the float32 ones); K11 also on a long
   memory (each lane's coefficient fixed in [0.999, 0.99999]) at 74 x
   20011 and at the headline, where two broken carries run beside it (its
   chunks' products zeroed, or formed in float) and the rules must reject
   the first, and at the headline the second; then each kernel's time
   there, K11's three stages timed apart, and ``ops/dynamics.py
   ballistics_parallel`` (several ops, a yardstick) at K8's;
7. ``main``: ``run_es`` with the basic chain, a random-weight Cnn14 at the
   deployed config, stereo T=262144 at 48 kHz, popsize 512, in each
   fft_mode ("mega2", which "auto" picks, then "mega", "mx" and "fused"):
   one warm-up block and one timed block of 2 generations, every kernel's
   launch count set to 0 before the timed run, read after it and held
   against what the mode must launch;
8. ``style``: the same run with the reference style chain
   ``chains/eq+multiband-comp+limiter.json`` (K6, then K8 in each of the
   multiband compressor's 3 bands and in the limiter), spans and peak
   memory;
9. ``comp``: the same run with the single-compressor chain (the one
   ``st_ito_tpu/eval/psm.py:44`` builds) with its bypass slot: K7, with
   its in-kernel blend, once per generation and no other kernel;
10. ``fx``: the same run with the fx chain, every effect of the rest of
   the chain (EQ -> noise gate -> chorus -> phaser -> gain -> stereo
   widener -> delay -> reverb, 49 parameters, built from
   ``EFFECT_REGISTRY``) in "auto" (mega2): K6, K8 (the gate's detector),
   K11 six times (the phaser's allpasses), K3 and K4 per generation and no
   other kernel; then one population of 37 rendered with the per-stage
   response path ("xla") and with "mx", held against each other; K11 on
   the phaser's own first-stage (coeff, drive) at 1024 lanes x 262144,
   and K8 on the gate's own detector input (512 lanes, its first 65536
   samples), each by the two rules with a float64 witness; each kernel's
   time on those inputs;
11. ``cli``: ``st_ito_torch.cli.run_optim.main`` on a stereo WAV of program
   material with the synthetic target and the default vst chain (K6, then
   K3 -> K4) at popsize 512, 3 iterations, T 262144 (the host CMA-ES, the
   CLI's gens_per_dispatch=1); then with ``--staged`` (2 iterations a
   stage) and with ``--savepop`` (popsize 16, 2 iterations: every
   generation's 16 ranked WAVs); launch counts per fitness call, and the
   written WAV and parameter JSON;
12. ``mfcc``: the same CLI run with ``--metric mfcc`` (the MFCC feature
   embed in place of the Cnn14): K6, K3 and K4 per fitness call, evals/s,
   the written WAV and parameter JSON;
13. ``long``: the JAX package's ``examples/chunked_es_tpu.py`` on the
   port: ``run_es`` with ``chunked=True`` on 60 s of stereo (T 2880000),
   popsize 128, chunks of 262144, blocks of 4 generations, the basic chain
   and the random-weight deployed Cnn14; a warm-up and a timed block, K1
   and K9 once per sub-batch (the automatic one, sized on the card) and
   no other kernel; the sub-batch, peak memory per candidate, spans and
   the output render's time; then K1 at that path's chunk length (on
   T_K1_LONG samples, by the two rules) and K9 at n 2^22;
14. ``multitrack``: ``run_es_multitrack``, 4 tracks x popsize 128 at T
   262144, a warm-up generation, then 2 timed: K1 on per-candidate input,
   K3 and K4 once per generation and once for the final batched render;
15. ``dtype``: bfloat16 against float32 fitness on a population of 64;
16. ``autodiff``: gradient ITO at full width, the deployed Cnn14 in
   float32 forward and backward: the CLI's ``--algorithm autodiff`` (the
   51-parameter processor) for a warm-up iteration and 10 timed ones, and
   with ``--metric mfcc``, whose loss must fall; ``run_autodiff`` through
   the basic chain's per-candidate renderer; no kernel launched; then the
   first step's loss and gradient on the card against the same step on
   the CPU (loss 1e-5 relative, gradient 1e-3 relative L2);
17. ``nofast``: the differentiable renderer (``fast=False``) in a device
   block of the CMA-ES at popsize 512, the basic chain, a warm-up and a
   timed block of 2 generations with no kernel launched; 8 candidates of
   its render against the CPU's (1e-4 x peak) and their distance from the
   fast renderer's;
18. ``eval``: ``run_synthetic_benchmark`` on the basic chain with
   ``run_es`` (popsize 64, 3 generations: K1, K3 and K4 each) and
   ``run_autodiff`` (3 iterations), the ``eval_psm`` CLI on 4 examples,
   ``eval_sweep`` on 5 points and ``effect_info --test``; finite scores
   and written JSON;
19. ``pst``: the PST benchmark CLI (``st_ito_torch.cli.eval_pst``) at
   its defaults (the general chain, two synthesized stereo pairs at T
   262144, popsize 128, 32 iterations, the random-weight deployed Cnn14,
   the param and MFCC metrics), its launch counts held: K1, K3 and K4 once
   per generation of its ``style-es`` runs and no other kernel; the four
   baseline encoders (FX-encoder, VGGish, Wav2CLIP, BEATs, each at its
   published config with random weights) held on a (4, 2, 262144) batch
   against their CPU runs (cosine per head), timed at batches of 1 and 8,
   with their peak memory, and scoring ``run_pst_benchmark``'s input and
   rule-based methods on one synthesized pair; the style-classification
   CLI (``eval_cls``) at its defaults; ``cli/embed.py`` with random
   weights, and the AFx-Rep ``.ckpt`` converter on a Lightning checkpoint
   of the random Cnn14 that the phase writes (the converted model's
   embeddings within 1e-6 of the source's). No kernel but the three is
   launched by any of it;
20. ``clap``: the LAION-CLAP tower at its published config
   (``laion/clap-htsat-unfused``) with random weights, written under
   transformers' names to ``checkpoints/clap-htsat-unfused.pt`` in a
   temporary directory and loaded by ``load_clap_laion_model``: its
   mid/side embeddings of a (4, 2, 262144) batch against the CPU's (cosine
   per head), timed at batches of 1 and 8, with peak and weight bytes; the
   training backbones at their ``cfg/pretext-*.yaml`` widths (HTS-AT, the
   CLAP-ft tower, DeepGCN-t with BatchNorm statistics from a train-mode
   pass over the batch on the CPU): an eval forward on that batch against
   the CPU (DeepGCN's CPU run given the card's k-NN picks, the picks that
   differ counted), a train-mode forward at batch 32 timed with its peak,
   DeepGCN's BatchNorm buffers after a train-mode forward against the
   CPU's (DeepGCN's picks again held); ``run_optim --metric clap`` from that directory on the vst
   chain at popsize 32 (K6, K3 and K4 once per fitness call and nothing
   else); ``run_es`` with the tower's mid/side metric on the basic chain
   at popsize 128 in mega2, a warm-up and a timed block (K1, K3 and K4 once
   a generation); the tower's forward with TF32 let through once, which
   must fail the phase's cosine limit (so that the limit sees TF32);
21. ``train``: training (ROADMAP §1 item 10) at full width. The preset
   bank over the 12 registry effects (10 presets, probe 32768) and
   ``generate_pretext_dataset`` of 256 examples at T 262144 in shards of
   64 on the card: each instance's sub-batch render through
   ``build_batched_render_fn(fast=True)`` (K6 the EQ, K7 the compressor,
   K8 the gate's, the multiband's 3 and the limiter's detectors, K11 x 6
   the phaser, K3 -> K4 delay, reverb, gain and widener), the launches
   held against the instances' sub-batch counts, 3 examples of each
   instance rendered again on their first T_HELD samples by the card and
   by the CPU and held (1e-4 x peak, the scans' floored at 1); the
   pretext CLI (``st_ito_torch.cli.train``) at ``cfg/pretext-panns.yaml``
   (Cnn14 512-d, batch 32, stereo T 262144, logging every step) for 8
   steps, then ``--resume`` to 10: ms a step after the first, examples/s,
   peak bytes, finite losses, the decode that ran; the exported
   ``encoder.npz`` loaded by ``load_param_model`` and used by a warm-up
   and a timed 2-generation ``run_es`` (K1, K3, K4 once a generation); the
   first pretext step (loss, gradient, BatchNorm buffers) of one weight
   set and batch of 2 on the card and on the CPU with the card's
   SpecAugment and dropout draws and each time max's frame replayed
   (loss 1e-5 relative; the gradient (a) within 1e-3 relative L2 of the
   CPU's, or (b) no farther from a float64 CPU run of the step than 4x
   the CPU's float32 gradient is, the card's also run with cuDNN off and
   every distance logged; buffers 1e-4; a frame the CPU would pick apart
   from the card's only at a near tie, its gap under 1e-5 relative); the
   style CLI at
   ``cfg/style-audio-otf.yaml`` (batch 16, T 262144, on-the-fly targets,
   the audio loss through the basic chain's differentiable renderer: no
   kernel) for 4 steps on a ``generate_style_dataset`` of 32, ms a step
   and peak; ``run_learned_inference`` from its state, timed, its
   parameters within 1e-5 of the CPU's;
22. ``mesh``: the device mesh (``st_ito_torch.parallel``). (a) An NCCL
   group of world size 1 on the card: ``run_es`` at the headline (the
   ``main`` phase's run in mega2, one block of 2 generations) held bit for
   bit against the same run without a group, its launches counted; then 2
   pretext steps at ``cfg/pretext-panns.yaml`` (batch 32) on the "data"
   mesh, each against the same step without a group from the same state,
   by the ``train`` phase's rules (loss 1e-5 relative, the gradient within
   1e-3 relative L2: cuDNN's float32 backward sums differ from run to
   run). (b) 2 gloo ranks on the
   one card, started by the phase (NCCL refuses two ranks on one card):
   the headline population split at 256 a rank, the fitness in float32
   (the split population's K1, K3 and K4 at B 256, the fitness
   all-gathered through host memory) within 1e-5 of one process's on the
   same population, then a block of ``run_es`` whose first generation's
   best lies within 1e-5 of one process's; both ranks return the same;
23. the ``kernels`` JSON line, then the card line and the result line.
   A kernel's launches there come from the timed run of a path that
   launches it: K11's from ``fx``, the one path that does.
Each phase logs the card's SM and memory clocks, power draw and
temperature (nvidia-smi) at its start and end.

Tolerances: K1, a chunked scan whose carries round differently from the
serial chain, (a) where a lane's distortion is bypassed within 1e-4 x
max(1, the lane's peak) of the float32 plain version (B 37 x T 20011,
128 lanes x T 65536 and the long path's lanes x T_K1_LONG in that path's
chunks; logged at the headline, where the float32 plain run itself can lie
farther than that from float64), and (b) on every lane of every
set no farther from a float64 run of the plain version than 4x the float32
one is, plus 1e-5 x max(1, peak); K6, K7, K8 and K11, chunked scans too,
by the same two rules on every lane of every set (``chunked.gate_excess``),
with their first chunk bitwise; a lane may miss (a) only where the float32
plain run itself lies farther than 1e-4 x peak from float64, and the log
counts such lanes (at K6's headline also where the kernel lies at most
``chunked.A_EXCUSE`` = 1.25x as far from float64 as that run does);
every other kernel 1e-4 x max|want|
per output array on the valid bins (K9 and K2, which divide approximately
as K3 does, and the FFTs, which cannot match cuFFT bitwise); the groups
atol 5e-5, rtol 1e-4 against the mx path on a peak-normalised input;
the baseline encoders at cosine 1 - 1e-3 of the CPU per item and head,
the CLAP tower and the backbones at 1 - 1e-8 (sound runs read 1 - 1e-10
to 1 - 1e-13; TF32 reads farther), DeepGCN's BatchNorm buffers 1e-4
(relative, floored at 1); a DeepGCN node whose k-NN picks differ between
the card and the CPU only at a near tie (its k-th and (k+1)-th float64
distances within 1e-5, relative) and at most 1% of a graph conv's nodes.

``--record PATH`` also writes the full record, compiler reports included,
as JSON. ``--phases`` runs a subset (a development aid: a partial run
prints no kernels line and no result line). There is no CPU path: without
a card the script exits non-zero and prints no result.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

SR = 48000
T_HEAD = 262144
POP = 512
GENS = 2

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM rate and float32
# outside the tensor cores; both kernels are float32 CUDA-core code.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float32 operations per sample and lane of K1 (a transcendental counts as
# one): 6 biquads x 9, EQ blend 4, gain computer 12, ballistics 9, gain
# apply 4, comp blend 4, tanh distortion 3, dist blend 4.
K1_OPS_PER_SAMPLE = 94
# float32 operations per (candidate, bin) of K9 with delay + reverb: the
# delay's response 30, the reverb's 16 comb reciprocals (9 each) plus 40,
# two bypass blends 8, one monomix composition 24, packed coefficients 16,
# the packed apply 28, the DC/Nyquist blend amortised to 0.
K9_OPS_PER_BIN = 30 + 16 * 9 + 40 + 8 + 24 + 16 + 28
# float32 operations per sample and lane: K6 6 biquads x 9 and the bypass
# blend 4; K8 the release stage 5 (min counted) and the attack stage 4.
K6_OPS_PER_SAMPLE = 58
K8_OPS_PER_SAMPLE = 9
# K7: the gain computer 18 (abs, floor, log, scale, over, the knee's half,
# h, h*h, slope*, 2*knee, the divide, 2*over, the negated knee, two
# compares, slope*over, two selects), the ballistics 9, the gain 4 (scale,
# exp and two products), the bypass blend 4; K11 a product and a sum.
K7_OPS_PER_SAMPLE = 18 + 9 + 4 + 4
K11_OPS_PER_SAMPLE = 2
STYLE_CHAIN = "chains/eq+multiband-comp+limiter.json"
CLI_ITERS = 3
# the CLI's --staged run (2 iterations a stage of the vst chain's 3) and
# its --savepop run (popsize 16, 2 iterations)
CLI_STAGED_ITERS = 2
CLI_SAVEPOP_POP = 16
# the long-audio phase: the JAX package's examples/chunked_es_tpu.py, 60 s
# of stereo at 48 kHz, popsize 128, chunks of 262144, blocks of 4
T_LONG = 60 * SR
POP_LONG = 128
GENS_LONG = 4
# K1 is held at the long path's chunk length on this much audio: its plain
# loop takes about 0.6 ms a sample step
T_K1_LONG = 65536
# K1 and K6 run on the whole headline and are held on their first T_HELD
# output samples against the plain runs on the input's first T_HELD (each
# plain loop takes one launch a sample step)
T_HELD = 65536
# the multitrack phase: 4 tracks x popsize 128 at the headline T
TRACKS = 4
POP_TRACK = 128
# gradient ITO: timed iterations after a warm-up one; the fast=False
# renderer's candidates held against the CPU; the eval phase's run_es
# (popsize, generations) and run_autodiff (iterations) per synthetic case,
# PSM examples and sweep points
AD_ITERS = 10
NOFAST_CHECK = 8
EVAL_ES_POP = 64
EVAL_ES_GENS = 3
EVAL_AD_ITERS = 3
EVAL_PSM_EXAMPLES = 4
EVAL_SWEEP_STEPS = 5
# the pst phase: each baseline encoder held on a batch of this many stereo
# items at the headline T against its CPU run (cosine per head above
# 1 - ENCODER_COS), and timed at these batches
ENCODER_CHECK_B = 4
ENCODER_COS = 1e-3
ENCODER_TIMED_B = (1, 8)
# the .ckpt round trip: the converted model's embeddings within this of
# the source model's
CKPT_TOL = 1e-6
# the clap phase: the CLI at its default popsize, run_es at this popsize
# (mega2, blocks of GENS), the backbones' train-mode forward at the
# cfg/pretext-*.yaml batch; the tower's and the backbones' embeddings at
# cosine above 1 - CLAP_COS of the CPU's (a few decades above the 1 - 1e-10
# to 1 - 1e-13 of sound runs, so that a forward with TF32 fails it);
# DeepGCN's BatchNorm buffers within BN_REL (relative, floored at 1) of the
# CPU's; a node's k-NN picks differing from the CPU's only at a near tie
# (its k-th and (k+1)-th float64 distances within KNN_TIE, relative), at
# most KNN_FLIP_SHARE of a graph conv's nodes
CLAP_CLI_POP = 32
CLAP_ES_POP = 128
BACKBONE_TRAIN_B = 32
CLAP_COS = 1e-8
BN_REL = 1e-4
KNN_TIE = 1e-5
KNN_FLIP_SHARE = 0.01
# the train phase (ROADMAP §1 item 10)
TRAIN_EXAMPLES = 256
TRAIN_SHARD = 64
TRAIN_PRESETS = 10
TRAIN_PROBE = 32768
TRAIN_SOURCES = 4
PRETEXT_STEPS = 8
PRETEXT_RESUME = 10
STYLE_STEPS = 4
STYLE_EXAMPLES = 32
TRAIN_CHECK_ROWS = 3
TRAIN_CHECK_B = 2
TRAIN_LOSS_REL = 1e-5
TRAIN_GRAD_REL = 1e-3
# the float32 gradient of train-mode BatchNorm convs cancels (each
# channel's backward sums to zero): on an H100 and its host the CPU's
# float32 gradient read 7.7e-4 from float64 (PERF.md §6), so the card's is
# held as the scans' rule (b) holds theirs: no farther from the float64
# witness than this many times the CPU's float32 run, where the 1e-3
# against the CPU misses
TRAIN_GRAD_WITNESS = 4.0
LEARNED_TOL = 1e-5
# the mesh phase: (a) an NCCL group of world size 1, held bit for bit
# (run_es) and by the train phase's rules (MESH_STEPS pretext steps);
# (b) 2 gloo ranks on the one card at MESH_POP_RANK candidates a rank, the
# fitness in float32 held within MESH_FIT_ABS of one process's, and the
# first pretext step on their "data" mesh by the train phase's rules
MESH_STEPS = 2
MESH_RANKS = 2
MESH_POP_RANK = 256
MESH_FIT_ABS = 1e-5
# kernel launches of one sub-batch render of each registry effect alone
# (build_batched_render_fn, fast=True, T 262144)
DATAGEN_KERNELS = {
    "parametric_eq": {"k6": 1}, "compressor": {"k7": 1},
    "noise_gate": {"k8": 1}, "multiband_compressor": {"k8": 3},
    "limiter": {"k8": 1}, "phaser": {"k11": 6},
    "delay": {"k3": 1, "k4": 1}, "reverb": {"k3": 1, "k4": 1},
    "gain": {"k3": 1, "k4": 1}, "stereo_widener": {"k3": 1, "k4": 1},
    "chorus": {}, "distortion": {}}
# the chorus has no kernel: its modulated delay (up to 480 samples) turns
# one ulp of the card's or the CPU's float32 sine into 1e-3 x peak
# (ROADMAP §3; 1.15e-3 read on 65536 samples on an H100, PERF.md §6)
DATAGEN_CHORUS = 3e-3
SCAN_EFFECTS = ("parametric_eq", "compressor", "noise_gate",
                "multiband_compressor", "limiter", "phaser")
PHASES = ("k1", "k9", "fft", "scan", "main", "style", "comp", "fx", "cli",
          "mfcc", "long", "multitrack", "dtype", "autodiff", "nofast",
          "eval", "pst", "clap", "train", "mesh")


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device ms of fn over reps calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def once_ms(fn):
    """(result, device ms) of one call."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def clocks(label, record):
    """Log and record the card's SM and memory clocks, power draw and
    temperature (nvidia-smi) at a phase's start or end."""
    line = subprocess.run(
        ["nvidia-smi",
         "--query-gpu=clocks.sm,clocks.mem,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"clocks {label}: {line}")
    record.setdefault("clocks", []).append([label, line])


def await_saved(path, job, timeout=900):
    """The tensor a spawned job saves at ``path`` (then deleted), once it
    is there; raises when the job ends without it or the time runs out."""
    t0 = time.perf_counter()
    while not os.path.exists(path):
        if not job.is_alive() and not os.path.exists(path):
            raise RuntimeError(f"the float64 plain job exited "
                               f"{job.exitcode} without writing {path}")
        if time.perf_counter() - t0 > timeout:
            raise RuntimeError(f"no {path} after {timeout} s")
        time.sleep(0.5)
    out = torch.load(path)
    os.unlink(path)
    return out


def spawn(target, *args):
    """A started process of its own (spawned) running target(*args)."""
    import multiprocessing

    job = multiprocessing.get_context("spawn").Process(target=target,
                                                       args=args)
    job.start()
    return job


def stop(job):
    """End a spawned job (killed if it still runs) and reap it."""
    if job.is_alive():
        job.kill()
    job.join()


# ------------------------------------------------------------------ K1


def k1_inputs(B, C, T, seed, shared, dev):
    """The kernel's (x_in, vec, S, with_dist, shared_channels) for a basic
    chain head with random parameters and mixed bypass masks."""
    from st_ito_torch.chain import basic_chain
    from st_ito_torch.chain.executor import stage_params
    from st_ito_torch.chain.responses import _eq_section_stack
    from st_ito_torch.ops.dynamics import _time_constant_alpha
    from st_ito_torch.ops.kernels import eqcomp

    rng = np.random.default_rng(seed)
    chain = basic_chain()
    W = torch.from_numpy(rng.random((B, chain.num_params)).astype(np.float32))
    (eq, es, _), (cp, cs, _), (ds, dstart, _) = chain.stage_slices()[:3]
    p_eq, p_c, p_d = (stage_params(s, W, st, 1)
                      for s, st in ((eq, es), (cp, cs), (ds, dstart)))
    b, a = _eq_section_stack(p_eq, SR)
    x = torch.from_numpy(rng.standard_normal(
        (C, T) if shared else (B, C, T)).astype(np.float32) * 0.5)

    def col(v):
        return torch.as_tensor(v, dtype=torch.float32)[:, None].to(dev)

    def act(s):
        return col((W[:, s] <= 0.5).float())

    return eqcomp.eqcomp_inputs(
        x.to(dev), b[:, None].to(dev), a[:, None].to(dev),
        threshold_db=col(p_c["threshold_db"]), ratio=col(p_c["ratio"]),
        knee_db=0.5,
        alpha_attack=col(_time_constant_alpha(p_c["attack_ms"], SR)),
        alpha_release=col(_time_constant_alpha(p_c["release_ms"], SR)),
        makeup_gain_db=0.0, eq_active=act(es), comp_active=act(cs),
        drive_db=col(p_d["drive_db"]), dist_gain_db=col(p_d["output_gain_db"]),
        dist_active=act(dstart), shared_lead_shape=(B, C) if shared else None
    )[:5]


def head_of(args, T):
    """A scan's input set (its signal first, per-lane tables after) cut to
    its first T samples."""
    return (args[0][..., :T].contiguous(),) + tuple(args[1:])


def k1_plain64_job(path, B, T, seed, shared, t_held=None):
    """The float64 plain run of the K1 set ``k1_inputs(B, 2, T, seed,
    shared)`` (on its first ``t_held`` samples, where given), written to
    ``path``: run in a process of its own (spawned), beside the float32 run
    in the main one, since each is bound by one core's rate of launches."""
    from st_ito_torch.ops.kernels import eqcomp

    args = k1_inputs(B, 2, T, seed, shared, torch.device("cuda"))
    if t_held is not None:
        args = head_of(args, t_held)
    torch.save(eqcomp.eqcomp_plain(*args, dtype=torch.float64).cpu(),
               path + ".tmp")
    os.replace(path + ".tmp", path)


def k1_check(args, label, rule_a=True, want64=None, L=None, got=None):
    """K1 against its plain version on one input set, under the kernel's
    two rules (``eqcomp.gate_excess``): (a) where a lane's distortion is
    bypassed, |kernel - plain float32| <= 1e-4 x max(1, the lane's peak);
    (b) on every lane, against a float64 run of the plain version,
    max_t |kernel - plain float64| <= 4 x max_t |plain float32 - plain
    float64| + 1e-5 x max(1, the lane's peak). Without ``rule_a`` rule (a)
    is logged and not held. ``want64`` returns the float64 run when it was
    made elsewhere. ``L``: launch the kernel in chunks of L samples (as
    ``tools/k1_chunks.py`` does) in place of the wrapper's own chunk for
    this shape. ``got``: the kernel's output on a longer input of which
    ``args`` holds the head, launched in chunks of ``L`` (the scan is
    causal: its first samples depend on those of the input alone). Returns
    (max |kernel - plain float32|, the plain version's ms)."""
    from st_ito_torch.ops.kernels import eqcomp
    from st_ito_torch.tools.k1_chunks import k1_launch

    lanes, T = args[1].shape[1], args[0].shape[-1]
    if got is not None:
        got = got[:, :T]
    elif L is None:
        L = eqcomp.chunk_len(lanes, T)
        got = eqcomp.eqcomp_cuda(*args)
    else:
        got = k1_launch(args, L)
    want, plain_ms = once_ms(lambda: eqcomp.eqcomp_plain(*args))
    want64 = (eqcomp.eqcomp_plain(*args, dtype=torch.float64)
              if want64 is None else want64().to(got.device))
    ex = eqcomp.gate_excess(got, want, args[1], args[2], args[3],
                            want64=want64)
    log(f"K1 {label}: chunk {L}, {-(-T // L)} chunks; max |kernel - plain| "
        f"{ex['max_err']!r} on all lanes, {ex['max_err_a']!r} where "
        f"the distortion is bypassed (rule a excess {ex['a']!r}"
        f"{'' if rule_a else ', not held'}); max |kernel - plain64| "
        f"{ex['max_err64']!r}, max |plain - plain64| "
        f"{ex['max_err64_plain']!r} (rule b excess {ex['b']!r}); first "
        f"chunk bitwise {bool(torch.equal(got[:, :L], want[:, :L]))} "
        f"(plain {plain_ms!r} ms)")
    if not math.isfinite(ex["max_err"]) or (rule_a and ex["a"] > 0.0) \
            or not ex["b"] <= 0.0:
        raise AssertionError(f"K1 misses its rules at {label}: {ex}")
    return ex["max_err"], plain_ms


def phase_k1(dev, rec):
    from st_ito_torch.ops.kernels import eqcomp

    # B 37: 74 lanes, three 32-lane blocks with the last one ragged; T 20011
    # is not a multiple of the 32-sample tile nor of the chunk; then 128
    # lanes x T 65536 over the full parameter ranges
    err = max(k1_check(k1_inputs(37, 2, 20011, 1, shared, dev),
                       f"B 37, T 20011, shared={shared}")[0]
              for shared in (True, False))
    err = max(err, k1_check(k1_inputs(64, 2, 65536, 3, False, dev),
                            "B 64, T 65536, shared=False")[0])
    # the main path's own shape: every block, over the whole of T, its
    # first T_HELD samples held against the plain runs on the input's first
    # T_HELD. Rule (a) is logged, not held: over the headline's samples the
    # float32 plain run itself lies up to 2.5e-4 x peak from the float64
    # one on lanes whose distortion is bypassed (the EQ's low, high-gain
    # sections), so no float32 order of rounding other than its own can
    # meet (a) there
    from st_ito_torch.ops.kernels import _build

    lanes = POP * 2
    rec["chunk"] = eqcomp.chunk_len(lanes, T_HEAD)
    path = _build.BUILD_DIR.parent / "k1_plain64.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    job = spawn(k1_plain64_job, str(path), POP, T_HEAD, 2, True, T_HELD)
    try:
        head = k1_inputs(POP, 2, T_HEAD, 2, True, dev)
        rec["ms"] = cuda_ms(lambda: eqcomp.eqcomp_cuda(*head), 3)
        rec["plain_shape"] = (f"headline B {POP}, shared, the first "
                              f"{T_HELD} of its {T_HEAD} samples")
        e, rec["plain_ms"] = k1_check(
            head_of(head, T_HELD), rec["plain_shape"], rule_a=False,
            want64=lambda: await_saved(str(path), job), L=rec["chunk"],
            got=eqcomp.eqcomp_cuda(*head))
    finally:
        stop(job)
    rec["max_abs_err"] = max(err, e)
    rec["bytes"] = 4 * (lanes * T_HEAD + head[0].numel() + head[1].numel())
    rec["operations"] = K1_OPS_PER_SAMPLE * lanes * T_HEAD
    log(f"K1 headline (lanes {lanes}, T {T_HEAD}, chunk {rec['chunk']}, "
        f"{T_HEAD // rec['chunk']} chunks): {rec['ms']!r} ms")


# ------------------------------------------------------------------ K9


def rp_stage_case(B, rng, dev):
    """Delay + reverb stages with fractional delays and mixed bypass."""
    delay = {"delay_seconds": rng.uniform(0.01, 1.0, B) + 0.37 / SR,
             "feedback": rng.uniform(0.05, 1.0, B),
             "mix": rng.uniform(0.0, 1.0, B)}
    reverb = {k: rng.uniform(0.0, 1.0, B)
              for k in ("room_size", "damping", "wet_dry", "width")}
    stages = []
    for effect, p in (("delay", delay), ("reverb", reverb)):
        m = rng.random(B) > 0.4
        m[0] = True
        stages.append((effect,
                       {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                        for k, v in p.items()},
                       torch.as_tensor(m, device=dev)))
    return stages


def whole_delay_seconds(D):
    """A float32 delay in seconds whose product with SR, rounded to float32
    as the response math forms it, is exactly D samples, or None."""
    ds = np.float32(D / SR)
    for _ in range(32):
        if np.float32(ds * np.float32(SR)) == D:
            return ds
        ds = np.nextafter(ds, np.float32(-np.inf))
    return None


# whole delays D = (2j + 1) 2^s samples, s in [8, 13], that a float32 delay
# in seconds gives exactly
RESONANT_D = [d for d in ((2 * j + 1) << s for j in range(3)
                          for s in range(8, 14))
              if whole_delay_seconds(d) is not None]


def resonant_stage_case(B, rng, dev):
    """Delay + reverb, the delay fully wet at its top feedback (0.999) with
    whole delays from RESONANT_D: every bin k with k D = 0 mod n sits on a
    resonance of the comb, where the response is magnified a
    thousandfold."""
    D = rng.choice(RESONANT_D, B)
    delay = {"delay_seconds": np.array([whole_delay_seconds(d) for d in D],
                                        np.float32),
             "feedback": np.ones(B, np.float32),
             "mix": np.ones(B, np.float32)}
    reverb = {k: rng.uniform(0.0, 1.0, B).astype(np.float32)
              for k in ("room_size", "damping", "wet_dry", "width")}
    return [(effect, {k: torch.as_tensor(v, device=dev)
                      for k, v in p.items()}, None)
            for effect, p in (("delay", delay), ("reverb", reverb))]


def k9_case(B, n, seed, dev):
    from st_ito_torch.ops.kernels import packed_response as k9

    rng = np.random.default_rng(seed)
    F = n // 2 + 1
    Z = [torch.from_numpy(rng.standard_normal((B, F)).astype(np.float32))
         .to(dev) for _ in range(4)]
    stages = rp_stage_case(B, rng, dev)
    tables = k9.rp_tables(["delay", "reverb"], SR, n, dev)
    return Z, stages, tables


def k9_check(case, label):
    """(max |kernel - plain|, that relative to max |Y|, plain ms) on one
    case; the relative error must stay within 1e-4."""
    from st_ito_torch.ops.kernels import packed_response as k9

    got = k9.packed_response_cuda(*case[0], *case[1:])
    want, plain_ms = once_ms(
        lambda: k9.packed_response_plain(*case[0], *case[1:]))
    scale = max(float(w.abs().max()) for w in want)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    rel = err / scale
    log(f"K9 {label}: max |kernel - plain| = {err!r}, max |Y| = {scale!r}, "
        f"relative {rel!r} (plain {plain_ms!r} ms)")
    if not math.isfinite(rel) or rel > 1e-4:
        raise AssertionError(f"K9 disagrees with its plain version: {rel}")
    return err, rel, plain_ms


def phase_k9(dev, rec):
    from st_ito_torch.ops.kernels import packed_response as k9

    n = 2 ** 19
    # B 100: two 64-candidate chunks per frequency tile, the second ragged
    err, rel, _ = k9_check(k9_case(100, n, 3, dev), "n 2^19, B 100")
    # the main path's own shape: all 8 candidate chunks of every tile
    case = k9_case(POP, n, 4, dev)
    e, r, rec["plain_ms"] = k9_check(case, f"headline n 2^19, B {POP}")
    rec["max_abs_err"] = max(err, e)
    rec["max_rel_err"] = max(rel, r)
    rec["ms"] = cuda_ms(lambda: k9.packed_response_cuda(*case[0], *case[1:]),
                        5)
    tables = case[2]
    F = n // 2 + 1
    rec["bytes"] = 4 * (8 * POP * F + tables["reverb"]["_packed"].numel()
                        + 9 * POP)
    rec["operations"] = K9_OPS_PER_BIN * POP * F
    log(f"K9 headline (B {POP}, F {F}): {rec['ms']!r} ms")


# ------------------------------------------------- K5, K4, K2, K3 (FFT)


def rel_err(got, want, F=None):
    """(max |got - want|, that over max |want|) over paired arrays; half
    grids are compared on their F valid bins."""
    err = scale = 0.0
    for g, w in zip(got, want):
        if F is not None:
            g = g.reshape(g.shape[0], -1)[:, :F]
            w = w.reshape(w.shape[0], -1)[:, :F]
        err = max(err, float((g - w).abs().max()))
        scale = max(scale, float(w.abs().max()))
    return err, err / scale


def hold(name, label, err, rel, limit=1e-4):
    log(f"{name} {label}: max |kernel - plain| = {err!r}, relative {rel!r}")
    if not math.isfinite(rel) or rel > limit:
        raise AssertionError(
            f"{name} disagrees with its plain version at {label}: {rel}")


def poison(Y, n):
    """Copies of (YloR, YloI, YhigR, YhigI) with NaN in every bin K4 must
    not read: Ylo past n/2, Yhig at 0 and from n/2 on."""
    out = []
    for i, y in enumerate(Y):
        flat = y.reshape(y.shape[0], -1).clone()
        if i < 2:
            flat[:, n // 2 + 1:] = float("nan")
        else:
            flat[:, 0] = float("nan")
            flat[:, n // 2:] = float("nan")
        out.append(flat.reshape(y.shape))
    return out


def lib_fwd(x, n):
    """cuFFT's forward transform with the glue that builds the half grids
    (what ops/lti.py does on the mx path): the library yardstick of K5."""
    F = n // 2 + 1
    Z = torch.fft.fft(torch.complex(x[:, 0], x[:, 1]), n=n, dim=-1)
    Zrev = torch.cat([Z[:, :1], torch.flip(Z[:, n // 2:], (-1,))], -1)
    return (Z[:, :F].real.contiguous(), Z[:, :F].imag.contiguous(),
            Zrev.real.contiguous(), Zrev.imag.contiguous())


def lib_inv(Y, n, T):
    """cuFFT's inverse with the reassembly glue: the yardstick of K4."""
    B, F = Y[0].shape[0], n // 2 + 1
    lo_r, lo_i, hi_r, hi_i = (y.reshape(B, -1) for y in Y)
    full = torch.complex(
        torch.cat([lo_r[:, :F], torch.flip(hi_r[:, 1:n // 2], (-1,))], -1),
        torch.cat([lo_i[:, :F], torch.flip(hi_i[:, 1:n // 2], (-1,))], -1))
    y = torch.fft.ifft(full, n=n, dim=-1)[:, :T]
    return torch.stack([y.real, y.imag], dim=1)


def fft_check(B, n, T, seed, dev, label, recs, timed=False):
    """K5, K2, K3 and K4 against their plain versions on one input set, and
    the two groups against the mx path; with ``timed`` also every time."""
    from st_ito_torch.ops import lti
    from st_ito_torch.ops.kernels import mega_fft as mf
    from st_ito_torch.ops.kernels import packed_response as k9

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 2, T)).astype(np.float32)
    x = torch.from_numpy(x / np.abs(x).max()).to(dev)
    stages = rp_stage_case(B, rng, dev)
    tables = k9.rp_tables(["delay", "reverb"], SR, n, dev)
    F = n // 2 + 1

    def note(name, err):
        recs[name]["max_abs_err"] = max(recs[name].get("max_abs_err", 0.0),
                                        err)

    Z_want = mf.fwd_pack_fft_plain(x, n)
    Z_got = mf.fwd_pack_fft_cuda(x, n)
    err, rel = rel_err(Z_got, Z_want, F)
    hold("K5", label, err, rel)
    note("k5", err)

    Y_want = k9.packed_response_padded_plain(*Z_want, stages, tables, n)
    err, rel = rel_err(
        k9.packed_response_padded_cuda(*Z_want, stages, tables, n), Y_want, F)
    hold("K2", label, err, rel)
    note("k2", err)

    Y_got = mf.fwd_pack_fft_response_cuda(x, stages, n, tables)
    err, rel = rel_err(Y_got, Y_want, F)
    hold("K3", label, err, rel)
    note("k3", err)
    split = k9.packed_response_padded_cuda(*Z_got, stages, tables, n)
    log(f"K3 {label}: max |K3 - K2(K5)| = {rel_err(Y_got, split, F)[0]!r}")
    del split, Z_got

    y_want = mf.inv_unpack_fft_plain(*Y_want, n, T)
    y_got = mf.inv_unpack_fft_cuda(*poison(Y_want, n), n, T)
    err, rel = rel_err([y_got], [y_want])
    hold("K4", label + ", NaN in the masked bins", err, rel)
    note("k4", err)
    del y_got, Y_got

    mx = lti.packed_lti_apply_rp(x, stages, n, tables)
    for name, fn in (
            ("K3 -> K4", mf.packed_lti_apply_mega2),
            ("K5 -> K2 -> K4", mf.packed_lti_apply_mega),
            ("K10 -> K9 -> K10", lambda x, stages, n, _sr: (
                lti.packed_lti_apply_rp(x, stages, n, tables,
                                        fft_impl="fused")))):
        y = fn(x, stages, n, SR)
        diff = (y - mx).abs()
        worst = float((diff - 1e-4 * mx.abs()).max())
        log(f"group {name} {label}: max |group - mx| = {float(diff.max())!r}"
            f", max |mx| = {float(mx.abs().max())!r}")
        if not math.isfinite(worst) or worst > 5e-5:
            raise AssertionError(
                f"group {name} misses atol 5e-5, rtol 1e-4 of the mx path "
                f"at {label}: excess {worst}")
        recs["groups"][name] = max(recs["groups"].get(name, 0.0),
                                   float(diff.max()))
        del y, diff
    del mx
    if not timed:
        return

    table_bytes = 4 * tables["reverb"]["_packed"].numel()
    fft_ops = 5 * n * int(math.log2(n)) * B
    io = 4 * (2 * B * T + 4 * B * F)
    for name, run, plain, lib, nbytes, ops in (
            ("k5", lambda: mf.fwd_pack_fft_cuda(x, n),
             lambda: mf.fwd_pack_fft_plain(x, n), lambda: lib_fwd(x, n),
             io, fft_ops),
            ("k2", lambda: k9.packed_response_padded_cuda(
                *Z_want, stages, tables, n),
             lambda: k9.packed_response_padded_plain(
                 *Z_want, stages, tables, n), None,
             4 * 8 * B * F + table_bytes + 4 * 9 * B, K9_OPS_PER_BIN * B * F),
            ("k3", lambda: mf.fwd_pack_fft_response_cuda(x, stages, n, tables),
             lambda: mf.fwd_pack_fft_response_plain(x, stages, n, tables),
             None, io + table_bytes + 4 * 9 * B,
             fft_ops + K9_OPS_PER_BIN * B * F),
            ("k4", lambda: mf.inv_unpack_fft_cuda(*Y_want, n, T),
             lambda: mf.inv_unpack_fft_plain(*Y_want, n, T),
             lambda: lib_inv(Y_want, n, T), io, fft_ops)):
        rec = recs[name]
        rec["ms"] = cuda_ms(run, 5)
        rec["plain_ms"] = cuda_ms(plain, 2)
        rec["library_ms"] = None if lib is None else cuda_ms(lib, 3)
        rec["bytes"], rec["operations"] = nbytes, ops
        log(f"{name.upper()} headline (B {B}, n {n}, T {T}): {rec['ms']!r} "
            f"ms, plain {rec['plain_ms']!r} ms, library "
            f"{rec['library_ms']!r} ms")
        torch.cuda.empty_cache()


def resonance_check(B, n, T, seed, dev, label):
    """K3, K2 and K9 at the delay's comb resonances
    (``resonant_stage_case``), where the response magnifies its rounding a
    thousandfold: each within 1e-4 x max|want| of its plain version, K3
    also of K5 -> K2. Returns each kernel's error against its plain version
    relative to max|want|."""
    from st_ito_torch.ops.kernels import mega_fft as mf
    from st_ito_torch.ops.kernels import packed_response as k9

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 2, T)).astype(np.float32)
    x = torch.from_numpy(x / np.abs(x).max()).to(dev)
    stages = resonant_stage_case(B, rng, dev)
    tables = k9.rp_tables(["delay", "reverb"], SR, n, dev)
    F = n // 2 + 1
    rels = {}
    got = mf.fwd_pack_fft_response_cuda(x, stages, n, tables)
    err, rels["k3"] = rel_err(got, mf.fwd_pack_fft_response_plain(
        x, stages, n, tables), F)
    hold("K3", f"{label}, on comb resonances", err, rels["k3"])
    Z = mf.fwd_pack_fft_plain(x, n)
    split = k9.packed_response_padded_cuda(*mf.fwd_pack_fft_cuda(x, n),
                                           stages, tables, n)
    hold("K3 against K2(K5)", f"{label}, on comb resonances",
         *rel_err(got, split, F))
    del got, split
    err, rels["k2"] = rel_err(
        k9.packed_response_padded_cuda(*Z, stages, tables, n),
        k9.packed_response_padded_plain(*Z, stages, tables, n), F)
    hold("K2", f"{label}, on comb resonances", err, rels["k2"])
    Z = [z.reshape(B, -1)[:, :F].contiguous() for z in Z]
    err, rels["k9"] = rel_err(k9.packed_response_cuda(*Z, stages, tables),
                              k9.packed_response_plain(*Z, stages, tables))
    hold("K9", f"{label}, on comb resonances", err, rels["k9"])
    return rels


def k4_check(B, n, T, seed, dev, label):
    """K4 alone against its plain version (1e-4 x max|want|) with NaN in
    every bin it must not read; returns max |kernel - plain|."""
    from st_ito_torch.ops.kernels import mega_fft as mf

    g = torch.Generator(device=dev).manual_seed(seed)
    Y = [torch.randn((B,) + mf.half_grid(n), generator=g, device=dev)
         for _ in range(4)]
    want = mf.inv_unpack_fft_plain(*Y, n, T)
    got = mf.inv_unpack_fft_cuda(*poison(Y, n), n, T)
    err, rel = rel_err([got], [want])
    hold("K4", label + ", NaN in the masked bins", err, rel)
    return err


def k10_check(B, n, in_len, sign, out_len, seed, dev, label):
    """K10 against its plain version on one input set (1e-4 x max|want|);
    returns (max |kernel - plain|, the inputs)."""
    from st_ito_torch.ops.kernels import fused_fft

    g = torch.Generator(device=dev).manual_seed(seed)
    z = [torch.randn((B, in_len), generator=g, device=dev) for _ in range(2)]
    want = fused_fft.fft_fused_plain(*z, sign=sign, n=n, out_len=out_len)
    got = fused_fft.fft_fused_cuda(*z, sign=sign, n=n, out_len=out_len)
    if [tuple(v.shape) for v in got] != [tuple(v.shape) for v in want]:
        raise AssertionError(f"K10 {label}: shapes {got[0].shape} against "
                             f"{want[0].shape}")
    err, rel = rel_err(got, want)
    hold("K10", label, err, rel)
    return err, z


def phase_k10(dev, rec):
    """K10 at B 37 (its scratch ring of one-candidate slots reused four
    times over): forward with a guard band, inverse with an out_len that is not
    a multiple of n1, below and above n/2; then the fused path's two
    headline calls in full, and their times beside torch.fft's."""
    from st_ito_torch.ops.kernels import fused_fft

    rec["scratch_slots"] = fused_fft.scratch_slots()
    log(f"K10: one persistent launch, chunks of one candidate, a scratch "
        f"ring of {rec['scratch_slots']} candidates "
        f"({rec['scratch_slots'] * 8 * 2 ** 19 / 2 ** 20!r} MiB at n 2^19)")
    errs = [k10_check(37, n, in_len, sign, out_len, 50 + i, dev,
                      f"B 37, n {n}, in_len {in_len}, sign {sign}, "
                      f"out_len {out_len}")[0]
            for i, (n, in_len, sign, out_len) in enumerate((
                (2 ** 14, 2 ** 13, -1, None), (2 ** 14, 2 ** 14, 1, 1000),
                (2 ** 15, 37 * 128, -1, None), (2 ** 15, 2 ** 15, 1, 20001)))]
    n = 2 ** 19
    fft_ops = 5 * n * int(math.log2(n)) * POP
    for d, (sign, in_len, out_len) in (("fwd", (-1, T_HEAD, None)),
                                       ("inv", (1, n, T_HEAD))):
        e, z = k10_check(POP, n, in_len, sign, out_len, 60, dev,
                         f"headline {d}, B {POP}, n 2^19, in_len {in_len}, "
                         f"out_len {out_len or n}")
        errs.append(e)

        def run(fn, z=z, sign=sign, out_len=out_len):
            return fn(*z, sign=sign, n=n, out_len=out_len)

        rec[f"ms_{d}"] = cuda_ms(lambda: run(fused_fft.fft_fused_cuda), 5)
        rec[f"plain_ms_{d}"] = cuda_ms(lambda: run(fused_fft.fft_fused_plain),
                                       2)
        # the one PyTorch call for the same transform is torch.fft, which
        # with the planar split is the plain version itself
        rec[f"library_ms_{d}"] = cuda_ms(
            lambda: run(fused_fft.fft_fused_plain), 3)
        rec[f"bytes_{d}"] = 4 * 2 * POP * (in_len + (out_len or n))
        log(f"K10 headline {d} (B {POP}, n {n}, in_len {in_len}, out_len "
            f"{out_len or n}): {rec[f'ms_{d}']!r} ms, plain "
            f"{rec[f'plain_ms_{d}']!r} ms, library "
            f"{rec[f'library_ms_{d}']!r} ms")
        del z
        torch.cuda.empty_cache()
    # the kernels line's entry is per launch: the mean of the two calls the
    # fused path makes once each per generation
    for key in ("ms", "plain_ms", "library_ms", "bytes"):
        rec[key] = (rec[f"{key}_fwd"] + rec[f"{key}_inv"]) / 2
    rec["operations"] = fft_ops
    rec["max_abs_err"] = max(errs)


def phase_fft(dev, recs):
    # n 2^14 splits 128 x 128, n 2^15 splits 256 x 128; T = n/2 and a
    # T < n/2 that is a multiple of n2 = 128; B 37, so that the persistent
    # kernels' ring of 9 one-candidate slots is taken four times over
    sizes = ((2 ** 14, 2 ** 13), (2 ** 14, 33 * 128), (2 ** 15, 2 ** 14),
             (2 ** 15, 37 * 128))
    for i, (n, T) in enumerate(sizes):
        fft_check(37, n, T, 20 + i, dev, f"n {n}, T {T}, B 37", recs)
    # K4's scheduler at the populations that test it: 1 and 2 (fewer
    # candidates than the lag between a candidate's two passes), 9 and 10
    # (the ring of 9 slots filled, then taken again)
    for i, (n, T) in enumerate(sizes):
        for B in (1, 2, 9, 10):
            recs["k4"]["max_abs_err"] = max(
                recs["k4"].get("max_abs_err", 0.0),
                k4_check(B, n, T, 70 + 4 * i + B, dev,
                         f"n {n}, T {T}, B {B}"))
    # the delay fully wet at its top feedback, bins on its resonances (the
    # response there reaches about 1e6: the error is kept relative, apart
    # from max_abs_err)
    for i, (B, n, T) in enumerate(((37, 2 ** 14, 2 ** 13),
                                   (64, 2 ** 19, T_HEAD))):
        rels = resonance_check(B, n, T, 40 + i, dev, f"n {n}, T {T}, B {B}")
        for name, rel in rels.items():
            recs[name]["resonance_rel_err"] = max(
                recs[name].get("resonance_rel_err", 0.0), rel)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fft_check(POP, 2 ** 19, T_HEAD, 30, dev,
              f"headline n 2^19, T {T_HEAD}, B {POP}", recs, timed=True)
    torch.cuda.empty_cache()
    phase_k10(dev, recs["k10"])


# ------------------------------------------------------- K6, K7, K8, K11


def k6_inputs(B, C, T, seed, shared, dev):
    """K6's (x_in, vec, S, with_active, shared_channels) for the basic EQ
    with random parameters and a mixed bypass mask."""
    from st_ito_torch.chain import basic_chain
    from st_ito_torch.chain.executor import stage_params
    from st_ito_torch.chain.responses import _eq_section_stack
    from st_ito_torch.ops.kernels import scan

    rng = np.random.default_rng(seed)
    chain = basic_chain()
    W = torch.from_numpy(rng.random((B, chain.num_params)).astype(np.float32))
    eq, es, _ = chain.stage_slices()[0]
    b, a = _eq_section_stack(stage_params(eq, W, es, 1), SR)
    x = torch.from_numpy(rng.standard_normal(
        (C, T) if shared else (B, C, T)).astype(np.float32) * 0.5)
    act = (W[:, es] <= 0.5).float()[:, None].to(dev)
    return scan.biquad_cascade_inputs(
        x.to(dev), b[:, None].to(dev), a[:, None].to(dev), active=act,
        shared_lead_shape=(B, C) if shared else None)[:5]


def k8_inputs(lanes, T, seed, dev):
    """K8's (c_in, vec): gain-computer-like dB values (<= 0, a third of
    them exactly 0) and the style chain's attack/release ranges."""
    from st_ito_torch.ops.dynamics import _time_constant_alpha
    from st_ito_torch.ops.kernels import scan

    rng = np.random.default_rng(seed)
    c = -np.abs(rng.standard_normal((lanes, T)) * 12.0)
    c[rng.random((lanes, T)) < 0.33] = 0.0
    aa = _time_constant_alpha(rng.uniform(0.05, 100.0, lanes), SR)
    ar = _time_constant_alpha(rng.uniform(10.0, 1000.0, lanes), SR)
    return scan.ballistics_inputs(
        torch.from_numpy(c.astype(np.float32)).to(dev), aa.to(dev),
        ar.to(dev))[:2]


def k7_inputs(B, C, T, seed, with_active, dev):
    """K7's (x_in, vec, with_active) for the compressor stage of the
    single-compressor chain with random parameters and, with the bypass
    row, a mixed mask; program-like input with silent stretches (the gain
    computer's 1e-8 floor), made on the card."""
    from st_ito_torch.chain import EFFECT_REGISTRY, ChainSpec
    from st_ito_torch.chain.executor import stage_params
    from st_ito_torch.ops.dynamics import _time_constant_alpha
    from st_ito_torch.ops.kernels import scan

    rng = np.random.default_rng(seed)
    chain = ChainSpec((EFFECT_REGISTRY["compressor"](),), with_bypass=True)
    stage, start, _ = chain.stage_slices()[0]
    W = torch.from_numpy(rng.random((B, chain.num_params)).astype(np.float32))
    p = stage_params(stage, W, start, 1)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((B, C, T), generator=g, device=dev) * 0.5
    x[..., T // 3:T // 3 + 1000] = 0.0

    def col(v):
        return torch.as_tensor(v, dtype=torch.float32)[:, None].to(dev)

    return scan.compressor_fused_inputs(
        x, col(p["threshold_db"]), col(p["ratio"]), 0.5,
        col(_time_constant_alpha(p["attack_ms"], SR)),
        col(_time_constant_alpha(p["release_ms"], SR)), 0.0,
        active=col((W[:, start] <= 0.5).float()) if with_active else None)[:3]


def k11_inputs(lanes, T, seed, dev):
    """K11's (a, b): a decaying coefficient near 1 and a random drive, made
    on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    a = 0.9 + 0.099 * torch.rand((lanes, T), generator=g, device=dev)
    return a, torch.randn((lanes, T), generator=g, device=dev)


def scan_heads(dev):
    """The headline K6, K8 and K7 input sets by name, each made from its
    seed when called (the spawned float64 job makes them again)."""
    return {"k6": lambda: k6_inputs(POP, 2, T_HEAD, 42, True, dev),
            "k8": lambda: k8_inputs(POP, T_HEAD, 44, dev),
            "k7_active0": lambda: k7_inputs(POP, 2, T_HEAD, 47, False, dev),
            "k7_active1": lambda: k7_inputs(POP, 2, T_HEAD, 48, True, dev)}


def scan_plain(name):
    """The plain version of the chunked scan whose headline set is
    ``name``."""
    from st_ito_torch.ops.kernels import scan

    return {"k6": scan.biquad_cascade_plain,
            "k8": scan.ballistics_plain}.get(name,
                                             scan.compressor_fused_plain)


def scan_plain64_job(folder):
    """The float64 plain runs of the headline K6, K8 and K7 sets, each
    saved under ``folder`` as soon as it is made: run in a process of its
    own (spawned), beside the float32 runs of the main one."""
    for name, make in scan_heads(torch.device("cuda")).items():
        args = head_of(make(), T_HELD) if name == "k6" else make()
        out = scan_plain(name)(*args, dtype=torch.float64).cpu()
        tmp = os.path.join(folder, f"{name}.tmp")
        torch.save(out, tmp)
        os.replace(tmp, os.path.join(folder, f"{name}.pt"))
        del out
        torch.cuda.empty_cache()


def chunked_check(name, kernel, plain, args, label, L, want64=None,
                  excuse=False, got=None):
    """K6, K7, K8 or K11, chunked scans in chunks of L samples, against the
    plain version on one input set: the first chunk bitwise, then the two
    rules of ``chunked.gate_excess``: (b) on every lane; (a) on every lane,
    except that a lane may miss it where the float32 plain run itself lies
    farther than 1e-4 x peak from the float64 one (those lanes are counted
    in the log, and the lanes past (a) listed). With ``excuse`` a lane may
    also miss it where the kernel lies at most ``chunked.A_EXCUSE`` times
    as far from float64 as the float32 plain run does. ``want64`` returns the
    float64 run when it was made elsewhere. ``got``: the kernel's output on
    a longer input of which ``args`` holds the head (the scans are causal).
    Returns (max |kernel - plain float32|, the plain version's ms, the
    excess)."""
    from st_ito_torch.ops.kernels import chunked

    T = args[0].shape[-1]
    got = kernel(*args) if got is None else got[:, :T]
    want, plain_ms = once_ms(lambda: plain(*args))
    want64 = (plain(*args, dtype=torch.float64) if want64 is None
              else want64().to(got.device))
    ex = chunked.gate_excess(got, want, want64=want64)
    first = bool(torch.equal(got[:, :L], want[:, :L]))
    log(f"{name} {label}: chunk {L}, {-(-T // L)} chunks; max |kernel - "
        f"plain| {ex['max_err']!r} (rule a excess {ex['a']!r}; lanes "
        f"missing it where the float32 plain run lies past 1e-4 x peak of "
        f"float64: {ex['a_miss_plain_far']}, elsewhere: "
        f"{ex['a_miss_plain_near']}); max |kernel - plain64| "
        f"{ex['max_err64']!r}, max |plain - plain64| "
        f"{ex['max_err64_plain']!r} (rule b excess {ex['b']!r}); first "
        f"chunk bitwise {first}; of the lanes missing (a) elsewhere, "
        f"{ex['a_miss_unexcused']} lie past {chunked.A_EXCUSE} x the plain "
        f"run's distance from float64"
        f"{' (excused within it)' if excuse else ''} (plain {plain_ms!r} "
        f"ms)")
    if ex["a_miss_plain_far"] + ex["a_miss_plain_near"]:
        log_rule_a_misses(name, got, want, want64)
    near = ex["a_miss_unexcused"] if excuse else ex["a_miss_plain_near"]
    if not math.isfinite(ex["max_err"]) or not first or not ex["b"] <= 0.0 \
            or near > 0:
        raise AssertionError(f"{name} misses its rules at {label}: {ex}")
    return ex["max_err"], plain_ms, ex


def log_rule_a_misses(name, got, want, want64, most=6):
    """Log the lanes farthest past rule (a): each one's distances between
    the kernel and the float32 and float64 plain runs, and its peak."""
    peak = torch.clamp_min(want.abs().amax(1), 1.0).double()
    e32 = (got.double() - want.double()).abs().amax(1)
    e_plain = (want.double() - want64.double()).abs().amax(1)
    e64 = (got.double() - want64.double()).abs().amax(1)
    for i in torch.argsort(-(e32 / peak))[:most].tolist():
        if e32[i] <= 1e-4 * peak[i]:
            break
        log(f"  {name} lane {i}: |kernel - plain| {float(e32[i])!r}, "
            f"|plain - plain64| {float(e_plain[i])!r}, |kernel - plain64| "
            f"{float(e64[i])!r}, peak {float(peak[i])!r}")


def detector_check(name, kernel, plain, args, label, want64=None):
    """K7 or K8 by ``chunked_check``, in the wrapper's chunks."""
    from st_ito_torch.ops.kernels import scan

    L = scan.detector_chunk_len(*args[0].shape)
    return chunked_check(name, kernel, plain, args, label, L, want64)


def k6_check(args, label, want64=None, excuse=False, full=None):
    """K6 by ``chunked_check``, in the wrapper's chunks; with ``full``, the
    kernel runs on that input set, of which ``args`` holds the head."""
    from st_ito_torch.ops.kernels import scan

    launch = args if full is None else full
    L = scan.cascade_chunk_len(launch[1].shape[1], launch[0].shape[-1])
    got = None if full is None else scan.biquad_cascade_cuda(*full)
    return chunked_check("K6", scan.biquad_cascade_cuda,
                         scan.biquad_cascade_plain, args, label, L, want64,
                         excuse, got)


def phase_scan(dev, recs):
    from st_ito_torch.ops.kernels import _build

    # the headline float64 witnesses of K8 and K7 run beside all of
    # scan_checks, in a process of their own
    folder = _build.BUILD_DIR.parent / "scan_plain64"
    folder.mkdir(parents=True, exist_ok=True)
    job = spawn(scan_plain64_job, str(folder))
    try:
        scan_checks(dev, recs, lambda name: lambda: await_saved(
            str(folder / f"{name}.pt"), job))
    finally:
        stop(job)


def scan_checks(dev, recs, want64):
    """The scan phase's checks and times; want64(name) returns a function
    that returns the float64 plain run of the headline set ``name``."""
    from st_ito_torch.ops import dynamics
    from st_ito_torch.ops.kernels import scan

    heads = scan_heads(dev)
    k6, k8 = recs["k6"], recs["k8"]
    # 74 lanes: three 32-lane blocks, the last ragged; T 20011 is not a
    # multiple of the 32-sample tile
    ragged = "B 37, stereo, T 20011"
    # K6 (chunks of 256, 79 of them, the last ragged) on a shared and a
    # per-candidate input, then the CLI's shape on the shared input in full
    errs = [k6_check(k6_inputs(37, 2, 20011, 40 + shared, shared, dev),
                     f"{ragged}, shared={shared}")[0]
            for shared in (True, False)]
    # At the headline a lane may also miss rule (a) where the kernel lies
    # at most chunked.A_EXCUSE x as far from float64 as the float32 plain run
    # does: the cascade's float32 rounding on its low, high-Q lanes reaches
    # about 1e-4 x peak over 262144 samples, so two float32 orders of
    # rounding of such a lane, the serial one and the chunked one, can lie
    # farther apart than that although each lies about as near float64 as
    # the other
    lanes = 2 * POP
    head = heads["k6"]()
    k6["plain_shape"] = (f"headline lanes {lanes}, shared input, the first "
                         f"{T_HELD} of its {T_HEAD} samples")
    e, k6["plain_ms"], ex = k6_check(head_of(head, T_HELD),
                                     k6["plain_shape"], want64("k6"),
                                     excuse=True, full=head)
    k6["a_miss_plain_near"] = ex["a_miss_plain_near"]
    k6["a_miss_unexcused"] = ex["a_miss_unexcused"]
    k6["max_abs_err"] = max(errs + [e])
    k6["a_miss_plain_far"] = ex["a_miss_plain_far"]
    k6["chunk"] = scan.cascade_chunk_len(lanes, T_HEAD)
    # the function's own traffic: the output, the shared input and the
    # coefficients once each; the carry table's four trips (pass A writes
    # it, the carry reads and rewrites it, pass D reads it) are the chunked
    # design's, logged beside it
    k6["bytes"] = 4 * (lanes * T_HEAD + head[0].numel() + head[1].numel())
    k6["carry_table_bytes"] = 4 * 4 * (-(-T_HEAD // k6["chunk"])
                                       * scan.CASCADE_ROWS * lanes)
    k6["operations"] = K6_OPS_PER_SAMPLE * lanes * T_HEAD
    k6_head = head  # timed below, once the float64 job has ended
    torch.cuda.empty_cache()

    # K8: 37 lanes (two blocks, the last ragged) x T 20011 in 79 chunks of
    # 256 (the last ragged), then the style chain's 512 lanes in full
    e_small, _, _ = detector_check("K8", scan.ballistics_cuda,
                                   scan.ballistics_plain,
                                   k8_inputs(37, 20011, 43, dev),
                                   "lanes 37, T 20011")
    head = heads["k8"]()
    k8["plain_shape"] = f"headline lanes {POP}, T {T_HEAD}"
    e, k8["plain_ms"], ex = detector_check(
        "K8", scan.ballistics_cuda, scan.ballistics_plain, head,
        k8["plain_shape"], want64("k8"))
    k8["max_abs_err"] = max(e_small, e)
    k8["a_miss_plain_far"] = ex["a_miss_plain_far"]
    k8["chunk"] = scan.detector_chunk_len(POP, T_HEAD)
    k8["bytes"] = 4 * (2 * POP * T_HEAD + head[1].numel())
    k8["operations"] = K8_OPS_PER_SAMPLE * POP * T_HEAD
    k8_head = head  # timed below, once the float64 job has ended

    # K7 with and without its bypass row, on 74 lanes and then on the
    # compressor-led chain's 1024 in full; timed with the row, as the
    # chain runs it
    k7 = recs["k7"]
    errs = [detector_check("K7", scan.compressor_fused_cuda,
                           scan.compressor_fused_plain,
                           k7_inputs(37, 2, 20011, 45 + act, act, dev),
                           f"{ragged}, active={act}")[0]
            for act in (True, False)]
    k7["plain_shape"] = f"headline lanes {lanes}, T {T_HEAD}, active row"
    k7["a_miss_plain_far"] = 0
    for act in (False, True):
        name = f"k7_active{int(act)}"
        head = heads[name]()
        e, k7["plain_ms"], ex = detector_check(
            "K7", scan.compressor_fused_cuda, scan.compressor_fused_plain,
            head, f"headline lanes {lanes}, T {T_HEAD}, active={act}",
            want64(name))
        errs.append(e)
        k7["a_miss_plain_far"] += ex["a_miss_plain_far"]
        if not act:
            del head
            torch.cuda.empty_cache()
    k7["max_abs_err"] = max(errs)
    # every float64 run is in: the spawned job no longer shares the card
    k6["ms"] = cuda_ms(lambda: scan.biquad_cascade_cuda(*k6_head), 3)
    log(f"K6 headline (lanes {lanes}, T {T_HEAD}, shared, chunk "
        f"{k6['chunk']}): {k6['ms']!r} ms; the function's bytes "
        f"{k6['bytes']}, the carry table's four trips "
        f"{k6['carry_table_bytes']} more")
    del k6_head
    k8["ms"] = cuda_ms(lambda: scan.ballistics_cuda(*k8_head), 3)
    log(f"K8 headline (lanes {POP}, T {T_HEAD}, chunk {k8['chunk']}): "
        f"{k8['ms']!r} ms")
    # a yardstick of several PyTorch ops, not a library call: the exact
    # parallel form (two doubling scans of 18 steps)
    c, aa, ar = k8_head[0], k8_head[1][0][:, None], k8_head[1][1][:, None]
    k8["ballistics_parallel_ms"] = cuda_ms(
        lambda: dynamics.ballistics_parallel(c, aa, ar), 3)
    log(f"ops/dynamics.py ballistics_parallel at K8's headline: "
        f"{k8['ballistics_parallel_ms']!r} ms")
    del k8_head, c
    torch.cuda.empty_cache()
    k7["chunk"] = scan.detector_chunk_len(lanes, T_HEAD)
    k7["ms"] = cuda_ms(lambda: scan.compressor_fused_cuda(*head), 3)
    k7["bytes"] = 4 * (2 * lanes * T_HEAD + head[1].numel())
    k7["operations"] = K7_OPS_PER_SAMPLE * lanes * T_HEAD
    log(f"K7 headline (lanes {lanes}, T {T_HEAD}, active row, chunk "
        f"{k7['chunk']}): {k7['ms']!r} ms")
    del head
    torch.cuda.empty_cache()

    # K11: 74 lanes (three blocks, the last ragged) x T 20011 in 79 chunks
    # of 256 (the last ragged), then the fx chain's 1024 lanes in full, each
    # against float32 and float64 runs of its plain version, on k11_inputs
    # and on a long memory, where two broken carries must miss the rules
    k11 = recs["k11"]
    e_small, _, _ = k11_check(k11_inputs(74, 20011, 48, dev),
                              "lanes 74, T 20011")
    e_long, k11["long_broken_b"] = k11_long_check(
        k11_long_inputs(74, 20011, 50, dev), "long memory, lanes 74, "
        "T 20011", float_must_fail=False)
    head = k11_long_inputs(lanes, T_HEAD, 51, dev)
    e_head_long, k11["head_long_broken_b"] = k11_long_check(
        head, f"long memory, headline lanes {lanes}, T {T_HEAD}",
        float_must_fail=True)
    del head
    torch.cuda.empty_cache()
    head = k11_inputs(lanes, T_HEAD, 49, dev)
    k11["plain_shape"] = f"headline lanes {lanes}, T {T_HEAD}"
    e, k11["plain_ms"], ex = k11_check(head, k11["plain_shape"])
    k11["max_abs_err"] = max(e_small, e_long, e_head_long, e)
    k11["a_miss_plain_far"] = ex["a_miss_plain_far"]
    k11["chunk"] = scan.linrec_chunk_len(lanes, T_HEAD)
    k11["ms"] = cuda_ms(lambda: scan.linear_recurrence_cuda(*head), 3)
    k11["stages_ms"] = k11_stages_ms(*head)
    # the function's bytes, each input read once and the output written
    # once; the design's own traffic reads both inputs twice (passes A and
    # D), its floor logged beside the bound
    k11["bytes"] = 4 * 3 * lanes * T_HEAD
    k11["traffic_floor_ms"] = 4 * 5 * lanes * T_HEAD / HBM_BYTES_PER_S * 1e3
    k11["operations"] = K11_OPS_PER_SAMPLE * lanes * T_HEAD
    log(f"K11 headline (lanes {lanes}, T {T_HEAD}, chunk {k11['chunk']}): "
        f"{k11['ms']!r} ms; stages {k11['stages_ms']} ms; bound "
        f"{k11['bytes'] / HBM_BYTES_PER_S * 1e3!r} ms (the function's "
        f"bytes), the design's traffic floor {k11['traffic_floor_ms']!r} ms")
    del head
    torch.cuda.empty_cache()


def k11_check(args, label):
    """K11 by ``chunked_check`` in the wrapper's chunks, against float32 and
    float64 runs of its plain version."""
    from st_ito_torch.ops.kernels import scan

    L = scan.linrec_chunk_len(*args[0].shape)
    return chunked_check("K11", scan.linear_recurrence_cuda,
                         scan.linear_recurrence_plain, args, label, L)


def k11_long_inputs(lanes, T, seed, dev):
    """K11's (a, b) with a long memory: each lane's coefficient fixed in
    U[0.999, 0.99999] (the phaser's allpass with its sweep held, at a
    longer memory than its 20 Hz floor's 0.9974), so that a chunk's product
    of coefficients P_k is 0.77 to 0.998 over 256 samples and 0.36 to 0.99
    over 1024, and the carry's term P_k y_k is most of each chunk's start;
    a random drive. Made on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    a = 0.999 + 0.00099 * torch.rand((lanes, 1), generator=g, device=dev)
    return (a.expand(lanes, T).contiguous(),
            torch.randn((lanes, T), generator=g, device=dev))


def k11_long_check(args, label, float_must_fail):
    """K11 by ``chunked_check`` on a long memory (``k11_long_inputs``), then
    two broken carries against the same plain runs: after pass A, the
    carry table's P_k row zeroed (the carry drops P_k y_k), or set to the
    chunk's product formed in float (one float product a sample, pass A's
    order), then the carry and pass D. The rules must reject the first
    carry, and the second where ``float_must_fail``: a float product drifts
    by up to Lc/2 ulp, which shows over many long chunks (the headline's
    256 of 1024) and not over 79 of 256. Returns (max |kernel - plain|,
    each broken carry's rule (b) excess)."""
    from st_ito_torch.ops.kernels import chunked, scan

    a_in, b_in = args
    lanes, T = a_in.shape
    want = scan.linear_recurrence_plain(a_in, b_in)
    want64 = scan.linear_recurrence_plain(a_in, b_in, dtype=torch.float64)
    L, table = scan.linrec_table(lanes, T, a_in.device)
    e, _, _ = chunked_check("K11", scan.linear_recurrence_cuda,
                            lambda *_: want, args, label, L,
                            want64=lambda: want64)
    n = table.shape[0]
    chunks = a_in[:, :(n - 1) * L].reshape(lanes, n - 1, L)
    p_float = torch.ones((lanes, n - 1), device=a_in.device)
    for j in range(L):
        p_float = p_float * chunks[:, :, j]
    del chunks
    out = torch.empty_like(a_in)
    broken_b = {}
    for name, p_row, must in (("P_k zeroed", torch.zeros_like(p_float), True),
                              ("P_k in float", p_float, float_must_fail)):
        scan.linear_recurrence_launch(a_in, b_in, out, table, L, 0)
        # row 1 of each chunk: P_k (csrc/scan.cu RecurrenceTable::kP)
        table[:n - 1, 1, :] = p_row.t()
        for stage in (1, 2):
            scan.linear_recurrence_launch(a_in, b_in, out, table, L, stage)
        ex = chunked.gate_excess(out, want, want64=want64)
        missed = ex["b"] > 0.0 or ex["a_miss_plain_near"] > 0
        broken_b[name] = ex["b"]
        log(f"K11 {label}, a broken carry, {name}: max |out - plain| "
            f"{ex['max_err']!r}, max |out - plain64| {ex['max_err64']!r} "
            f"(rule b excess {ex['b']!r}; lanes missing (a) where the "
            f"float32 plain run lies within 1e-4 x peak of float64: "
            f"{ex['a_miss_plain_near']}); the rules reject it: {missed}")
        if must and not missed:
            raise AssertionError(f"K11's rules at {label} pass a broken "
                                 f"carry ({name}): {ex}")
    return e, broken_b


def k11_stages_ms(a_in, b_in):
    """K11's three stages (pass A, the carry, pass D) timed apart by
    ``stages_ms``, its C entry point launched one stage at a time in the
    wrapper's chunks. Raises if the stages run apart differ from the whole
    scan."""
    from st_ito_torch.ops.kernels import scan

    L, table = scan.linrec_table(*a_in.shape, a_in.device)
    out = torch.empty_like(a_in)
    parts = stages_ms(lambda s: scan.linear_recurrence_launch(
        a_in, b_in, out, table, L, s), 3)
    if not torch.equal(out, scan.linear_recurrence_cuda(a_in, b_in)):
        raise AssertionError("K11's stages run apart differ from the whole "
                             "scan")
    return dict(zip(("pass_a", "carry", "pass_d"), parts))


def stages_ms(launch, n_stages, reps=3):
    """A chunked scan's stages timed apart: launch(s) launches stage s; the
    stages in order, reps rounds after one warm-up round, with a CUDA event
    after each launch. Returns each stage's mean ms."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(n_stages + 1)]
    parts = [0.0] * n_stages
    for r in range(reps + 1):
        torch.cuda.synchronize()
        ev[0].record()
        for s in range(n_stages):
            launch(s)
            ev[s + 1].record()
        ev[-1].synchronize()
        if r:  # round 0 warms up
            for s in range(n_stages):
                parts[s] += ev[s].elapsed_time(ev[s + 1]) / reps
    return parts


# ------------------------------------------------------------ main path


def program_audio(seed, T):
    """(1, 2, T) program material: a noise floor under enveloped partials
    (white noise alone makes every candidate embed alike)."""
    rng = np.random.default_rng(seed)
    t = np.arange(T, dtype=np.float32) / SR
    sig = 0.05 * rng.standard_normal((2, T)).astype(np.float32)
    for f0, amp in ((110.0, 0.3), (220.0, 0.22), (331.0, 0.15),
                    (551.0, 0.1), (1103.0, 0.07)):
        env = (0.5 + 0.5 * np.sin(2 * np.pi * (0.31 * amp + 0.13) * t))
        sig += (amp * env * np.sin(2 * np.pi * f0 * t + rng.uniform(0, 6.28))
                ).astype(np.float32)
    return torch.from_numpy(sig[None] * 0.5)


def styled_target(x, chain, dev, seed):
    """x rendered through the basic chain at one random setting."""
    from st_ito_torch.chain import build_batched_render_fn

    w = torch.from_numpy(np.random.default_rng(seed).uniform(
        0.25, 0.75, (1, chain.num_params)).astype(np.float32))
    return build_batched_render_fn(chain, SR, 2, device=dev)(
        w, x[0].to(dev))


def launch_counts(reset=False):
    """Every kernel's launch count; with ``reset`` set them all to 0."""
    from st_ito_torch.ops.kernels import eqcomp, fused_fft
    from st_ito_torch.ops.kernels import mega_fft as mf
    from st_ito_torch.ops.kernels import packed_response as k9
    from st_ito_torch.ops.kernels import scan

    if reset:
        eqcomp.launches = k9.launches = k9.launches_padded = 0
        fused_fft.launches = 0
        for counts in (mf.launches, scan.launches):
            for name in counts:
                counts[name] = 0
    return {"k1": eqcomp.launches, "k9": k9.launches,
            "k2": k9.launches_padded, "k5": mf.launches["fwd_pack_fft"],
            "k3": mf.launches["fwd_pack_fft_response"],
            "k4": mf.launches["inv_unpack_fft"],
            "k6": scan.launches["biquad_cascade"],
            "k7": scan.launches["compressor_fused"],
            "k8": scan.launches["ballistics"],
            "k10": fused_fft.launches,
            "k11": scan.launches["linear_recurrence"]}


# the kernels each fft_mode launches per generation; the others stay 0
MODE_KERNELS = {"mega2": {"k1": 1, "k3": 1, "k4": 1},
                "mega": {"k1": 1, "k5": 1, "k2": 1, "k4": 1},
                "mx": {"k1": 1, "k9": 1},
                "fused": {"k1": 1, "k9": 1, "k10": 2}}


def phase_main(dev, model, rec, fft_mode, chain=None, label=None,
               want_per_gen=None, embed_func=None, popsize=POP):
    """One warm-up and one timed block of ``run_es`` (at ``popsize``, with
    ``embed_func``, default the AFx-Rep's); the timed block's launch counts
    must equal ``want_per_gen`` x GENS (default: the fft_mode's kernels,
    ``MODE_KERNELS``) and every other kernel's 0."""
    from st_ito_torch.chain import basic_chain
    from st_ito_torch.ito import run_es
    from st_ito_torch.models import get_param_embeds
    from st_ito_torch.utils import phase_timer

    chain = basic_chain() if chain is None else chain
    label = fft_mode if label is None else label
    if want_per_gen is None:
        want_per_gen = MODE_KERNELS[fft_mode]
    x = program_audio(0, T_HEAD)
    y = styled_target(x, chain, dev, 1)
    common = dict(popsize=popsize, find_w0=False, sigma0=0.33,
                  crop_len=T_HEAD, seed=0, verbose=False,
                  early_stop_patience=10**9, gens_per_dispatch=GENS,
                  fft_mode=fft_mode,
                  embed_func=embed_func or get_param_embeds, device=dev)
    t0 = time.perf_counter()
    run_es(x, y, SR, chain, model, max_iters=GENS, **common)  # warm-up
    torch.cuda.synchronize()
    log(f"main path {label} warm-up block: "
        f"{time.perf_counter() - t0!r} s")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    phase_timer.reset(True)
    launch_counts(reset=True)
    res = run_es(x, y, SR, chain, model, max_iters=GENS, **common)
    launches = launch_counts()
    spans = phase_timer.read_ms()
    phase_timer.reset(False)

    # the path's kernels, want_per_gen each per generation, and none of the
    # others (the output render is plain PyTorch and launches none)
    want = {name: GENS * want_per_gen.get(name, 0) for name in launches}
    if launches != want:
        raise AssertionError(
            f"{label}: launches {launches} in {GENS} generations; expected "
            f"{want}")
    hist = np.asarray(res["fval_history"])
    if hist.shape != (GENS,) or not np.isfinite(hist).all():
        raise AssertionError(f"fitness history {hist}")
    out = res["output_audio"]
    if out.shape != (1, 2, T_HEAD) or not torch.isfinite(out).all():
        raise AssertionError("output audio is not finite (1, 2, T)")
    phases = {name: sum(ms) / GENS for name, ms in spans.items()}
    rec.update(
        evals_per_sec=res["evals_per_sec"],
        ms_per_generation=1e3 * res["time_elapsed"] / GENS,
        phase_ms_per_generation=phases, launches=launches,
        fval_history=hist.tolist(),
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    log(f"main path {label}: {res['evals_per_sec']!r} evals/s, "
        f"{rec['ms_per_generation']!r} ms/generation, launches {launches}")
    log(f"per-phase device ms per generation ({label}): "
        + json.dumps(phases))
    log(f"max_memory_allocated ({label}): "
        f"{rec['max_memory_allocated_bytes']} bytes")
    log(f"fitness history ({label}): {hist.tolist()}")
    return launches


def phase_style(dev, model, rec):
    """``run_es`` on the reference style chain: K6, then K8 once in each of
    the multiband compressor's 3 bands and once in the limiter."""
    from st_ito_torch.chain import chain_from_json

    chain = chain_from_json(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), STYLE_CHAIN))
    return phase_main(dev, model, rec, "auto", chain=chain, label="style",
                      want_per_gen={"k6": 1, "k8": 4})


def phase_comp(dev, model, rec):
    """``run_es`` on the single-compressor chain with its bypass slot: the
    broadcast input, then K7 with its in-kernel blend once per generation,
    and no other kernel."""
    from st_ito_torch.chain import EFFECT_REGISTRY, ChainSpec

    chain = ChainSpec((EFFECT_REGISTRY["compressor"](),), with_bypass=True)
    return phase_main(dev, model, rec, "auto", chain=chain, label="comp",
                      want_per_gen={"k7": 1})


# the fx chain: every stage of the registry's rest of the chain, 49
# parameters with the bypass slots
FX_STAGES = ("parametric_eq", "noise_gate", "chorus", "phaser", "gain",
             "stereo_widener", "delay", "reverb")
# the fx chain's kernels per generation: K6 (the EQ on the shared input),
# K8 (the gate's detector), K11 (the phaser's six allpasses), K3 -> K4 (the
# gain -> widener -> delay -> reverb group in mega2)
FX_KERNELS = {"k6": 1, "k8": 1, "k11": 6, "k3": 1, "k4": 1}
# the population the fx chain's two LTI paths ("xla", "mx") render
FX_POP_RENDER = 37
# K8 is held on the gate's own detector input over this many samples
T_K8_FX = 65536


def fx_chain():
    from st_ito_torch.chain import EFFECT_REGISTRY, ChainSpec

    return ChainSpec(tuple(EFFECT_REGISTRY[n]() for n in FX_STAGES),
                     with_bypass=True)


def capture_kernel_inputs(fn):
    """fn() with ``scan.linear_recurrence_cuda`` and ``ballistics_cuda``
    watched: the first inputs each one was given, as (a_in, b_in) and
    (c_in, vec), cloned."""
    from st_ito_torch.ops.kernels import scan

    seen = {}
    real = {name: getattr(scan, name) for name in (
        "linear_recurrence_cuda", "ballistics_cuda")}

    def watch(name):
        def call(*args):
            seen.setdefault(name, tuple(a.clone() for a in args))
            return real[name](*args)
        return call

    for name in real:
        setattr(scan, name, watch(name))
    try:
        fn()
    finally:
        for name, f in real.items():
            setattr(scan, name, f)
    return seen


def phase_fx(dev, model, rec, recs):
    """``run_es`` on the fx chain (EQ -> noise gate -> chorus -> phaser ->
    gain -> widener -> delay -> reverb, 49 parameters) in ``fft_mode``
    "auto" (mega2): K6, K8, K11 six times, K3 and K4 per generation and no
    other kernel. Then one population of 37 rendered in "xla" and in "mx"
    (the two LTI paths, atol 5e-5, rtol 1e-4 on a peak-normalised input);
    K11 on the phaser's own first-stage (coeff, drive) at the headline,
    and K8 on the gate's own detector input over T_K8_FX samples, each by
    the two rules; each kernel's time on those inputs."""
    from st_ito_torch.chain import build_batched_render_fn
    from st_ito_torch.ops.kernels import scan

    chain = fx_chain()
    launches = phase_main(dev, model, rec, "auto", chain=chain, label="fx",
                          want_per_gen=FX_KERNELS)

    # the two LTI paths on one population
    x = program_audio(40, T_HEAD)[0].to(dev)
    x = x / x.abs().max()
    W = torch.from_numpy(np.random.default_rng(41).random(
        (FX_POP_RENDER, chain.num_params)).astype(np.float32)).to(dev)
    renders = {mode: build_batched_render_fn(chain, SR, 2, fft_mode=mode,
                                             device=dev)(W, x)
               for mode in ("xla", "mx")}
    err = float((renders["xla"] - renders["mx"]).abs().max())
    torch.testing.assert_close(renders["xla"], renders["mx"], atol=5e-5,
                               rtol=1e-4)
    rec["xla_vs_mx_max_abs_err"] = err
    log(f"fx: the xla and mx LTI paths on {FX_POP_RENDER} candidates: max "
        f"|xla - mx| {err!r} (atol 5e-5, rtol 1e-4)")
    del renders
    torch.cuda.empty_cache()

    # the inputs the path gives K11 and K8: one render of the population
    W = torch.from_numpy(np.random.default_rng(42).random(
        (POP, chain.num_params)).astype(np.float32)).to(dev)
    render = build_batched_render_fn(chain, SR, 2, device=dev)
    seen = capture_kernel_inputs(lambda: render(W, x))
    del W
    torch.cuda.empty_cache()

    k11 = recs["k11"]
    a_in, b_in = seen["linear_recurrence_cuda"]
    label = f"the phaser's first stage, lanes {a_in.shape[0]}, T {T_HEAD}"
    e, k11["fx_plain_ms"], ex = k11_check((a_in, b_in), label)
    k11["max_abs_err"] = max(k11.get("max_abs_err", 0.0), e)
    k11["fx_max_abs_err"] = e
    k11["fx_a_miss_plain_far"] = ex["a_miss_plain_far"]
    k11["fx_ms"] = cuda_ms(lambda: scan.linear_recurrence_cuda(a_in, b_in), 3)
    k11["fx_bound_ms"] = 4 * 3 * a_in.numel() / HBM_BYTES_PER_S * 1e3
    log(f"K11 on {label}: {k11['fx_ms']!r} ms (bound "
        f"{k11['fx_bound_ms']!r} ms); coefficient in "
        f"[{float(a_in.min())!r}, {float(a_in.max())!r}]")
    del a_in, b_in, seen["linear_recurrence_cuda"]
    torch.cuda.empty_cache()

    k8 = recs["k8"]
    c_in, vec = seen.pop("ballistics_cuda")
    k8["fx_ms"] = cuda_ms(lambda: scan.ballistics_cuda(c_in, vec), 3)
    k8["fx_bound_ms"] = max(4 * (2 * c_in.numel() + vec.numel())
                            / HBM_BYTES_PER_S * 1e3,
                            K8_OPS_PER_SAMPLE * c_in.numel()
                            / FP32_OPS_PER_S * 1e3)
    log(f"K8 on the gate's detector input (lanes {c_in.shape[0]}, T "
        f"{T_HEAD}): {k8['fx_ms']!r} ms (bound {k8['fx_bound_ms']!r} ms); "
        f"c in [{float(c_in.min())!r}, {float(c_in.max())!r}] dB")
    if float(c_in.min()) < -100.0 or float(c_in.max()) > 0.0:
        raise AssertionError("the gate's detector input leaves [-100, 0] dB")
    head = (c_in[:, :T_K8_FX].contiguous(), vec)
    e, k8["fx_plain_ms"], ex = detector_check(
        "K8", scan.ballistics_cuda, scan.ballistics_plain, head,
        f"the gate's detector input, lanes {c_in.shape[0]}, T {T_K8_FX}")
    k8["max_abs_err"] = max(k8.get("max_abs_err", 0.0), e)
    k8["fx_max_abs_err"] = e
    k8["fx_a_miss_plain_far"] = ex["a_miss_plain_far"]
    del c_in, vec, head
    torch.cuda.empty_cache()
    return launches


def phase_mfcc(dev, rec):
    """The CLI with ``--metric mfcc`` on the default vst chain: K6, K3 and
    K4 once per fitness call and no other kernel; the written WAV and
    parameter JSON."""
    import tempfile

    from st_ito_torch.utils import save_audio

    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "program.wav")
        save_audio(wav, program_audio(3, T_HEAD)[0], SR)
        res, launches, wall, calls, _ = cli_run(
            dev, tmp, wav, "mfcc", POP, CLI_ITERS, ["--metric", "mfcc"])
    if calls != CLI_ITERS + 1:
        raise AssertionError(f"mfcc: {calls} fitness calls")
    rec.update(evals_per_sec=res["evals_per_sec"],
               time_elapsed=res["time_elapsed"], wall_s=wall,
               total_evals=res["total_evals"], launches=launches,
               fval_history=list(res["fval_history"]))
    return launches


def cli_run(dev, tmp, wav, name, popsize, iters, flags):
    """``run_optim.main`` on ``wav`` with the synthetic target, the vst
    chain and ``flags``; K6, K3 and K4 once per fitness call and no other
    kernel; the written WAV and parameter JSON finite at the expected
    shape. Returns (result, launches, wall s, fitness calls, run dir)."""
    from st_ito_torch.cli import run_optim
    from st_ito_torch.utils import load_audio

    out_dir = os.path.join(tmp, name)
    torch.cuda.synchronize()
    launch_counts(reset=True)
    t0 = time.perf_counter()
    res = run_optim.main([
        wav, "None", "--effect-type", "vst", "--popsize", str(popsize),
        "--max-iters", str(iters), "--max-length", str(T_HEAD),
        "--allow-random-model", "--output-dir", out_dir, "--device",
        dev.type] + flags)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    calls = res["total_evals"] // popsize
    want = {k: calls if k in ("k6", "k3", "k4") else 0 for k in launches}
    if launches != want:
        raise AssertionError(f"cli {name}: launches {launches} in {calls} "
                             f"fitness calls; expected {want}")
    run_dir = os.path.join(out_dir, "program_to_synthetic_target_es")
    audio, sr = load_audio(os.path.join(run_dir,
                                        "output_audio_sigma=0.33.wav"))
    with open(os.path.join(run_dir, "parameters_sigma=0.33.json")) as f:
        params = json.load(f)
    values = [v for stage in params.values() for v in stage.values()]
    hist = np.asarray(res["fval_history"])
    if (sr != SR or audio.shape != (2, T_HEAD)
            or not np.isfinite(audio).all() or np.abs(audio).max() == 0
            or not np.isfinite(values).all() or not np.isfinite(hist).all()):
        raise AssertionError(f"cli {name}: the output WAV, parameter JSON "
                             f"or fitness history is not finite at the "
                             f"expected shape")
    log(f"cli {name} (vst chain, popsize {popsize}, {iters} iterations"
        f"{', ' + ' '.join(flags) if flags else ''}): "
        f"{res['evals_per_sec']!r} evals/s, {wall!r} s wall, {calls} "
        f"fitness calls, launches {launches}, fitness {hist.tolist()}")
    return res, launches, wall, calls, run_dir


def phase_cli(dev, rec):
    """The CLI on a WAV file with the synthetic target and the default vst
    chain; K6, K3 and K4 once per fitness call (find_w0's and each
    iteration's) and no other kernel. Then ``--staged`` (each of the three
    stages in turn, no find_w0) and ``--savepop`` (every generation's
    renders written, ranked by fitness)."""
    import tempfile

    from st_ito_torch.utils import save_audio

    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "program.wav")
        save_audio(wav, program_audio(3, T_HEAD)[0], SR)
        res, launches, wall, calls, _ = cli_run(dev, tmp, wav, "default", POP,
                                                CLI_ITERS, [])
        if calls != CLI_ITERS + 1:
            raise AssertionError(f"cli: {calls} fitness calls")
        rec.update(evals_per_sec=res["evals_per_sec"],
                   time_elapsed=res["time_elapsed"], wall_s=wall,
                   total_evals=res["total_evals"], launches=launches,
                   fval_history=list(res["fval_history"]))

        res, st_launches, wall, calls, _ = cli_run(
            dev, tmp, wav, "staged", POP, CLI_STAGED_ITERS, ["--staged"])
        if calls != 3 * CLI_STAGED_ITERS or \
                len(res["fval_history"]) != 3 * CLI_STAGED_ITERS:
            raise AssertionError(f"cli --staged: {calls} fitness calls")
        rec["staged"] = dict(evals_per_sec=res["evals_per_sec"],
                             time_elapsed=res["time_elapsed"], wall_s=wall,
                             launches=st_launches,
                             fval_history=list(res["fval_history"]))

        res, sp_launches, wall, calls, run_dir = cli_run(
            dev, tmp, wav, "savepop", CLI_SAVEPOP_POP, 2, ["--savepop"])
        written = {g: sorted(os.listdir(os.path.join(run_dir, g)))
                   for g in ("pop_-1", "pop_0", "pop_1")}
        for g, names in written.items():
            ranks = sorted(int(n.split("_")[3]) for n in names)
            if ranks != list(range(CLI_SAVEPOP_POP)):
                raise AssertionError(f"cli --savepop: {g} holds {names}")
        if calls != 3:
            raise AssertionError(f"cli --savepop: {calls} fitness calls")
        rec["savepop"] = dict(evals_per_sec=res["evals_per_sec"],
                              time_elapsed=res["time_elapsed"], wall_s=wall,
                              launches=sp_launches,
                              files={g: len(n) for g, n in written.items()})
        log(f"cli --savepop wrote {rec['savepop']['files']} WAVs")
    return launches


# ------------------------------------------------------ long audio, tracks


def phase_long(dev, model, rec):
    """The long-audio ES (``run_es`` with ``chunked=True``): 60 s stereo,
    popsize 128, chunks of 262144, blocks of 4 generations; one warm-up
    block, then one timed block whose launches must be K1 and K9 once per
    sub-batch per generation and no other kernel (the LTI group runs
    ``mx``: ``mega_fft.supported`` rejects T 2880000). Then K1 at the
    chunk length of that path's lanes against its plain version under the
    two rules (T_K1_LONG samples), and K9 at n 2^22 and the sub-batch."""
    from st_ito_torch.chain import basic_chain, build_render_fn
    from st_ito_torch.ito import engine, run_es
    from st_ito_torch.ops.iir import next_pow2
    from st_ito_torch.ops.kernels import _build, eqcomp
    from st_ito_torch.ops.kernels import packed_response as k9
    from st_ito_torch.utils import phase_timer

    chain = basic_chain()
    x = program_audio(10, T_LONG).to(dev)
    w_target = torch.from_numpy(np.random.default_rng(0).uniform(
        0.25, 0.75, chain.num_params).astype(np.float32))
    render = build_render_fn(chain, SR, 2, device=dev)
    y = render(w_target, x[0])[None]
    picked = []
    real = engine.make_fitness_fn

    def spy(*a, **k):
        picked.append(k["pop_microbatch"])
        return real(*a, **k)

    common = dict(popsize=POP_LONG, crop_len=T_HEAD, chunked=True,
                  gens_per_dispatch=GENS_LONG, max_iters=GENS_LONG,
                  sigma0=0.3, find_w0=False, seed=0, verbose=False,
                  early_stop_patience=10**9, device=dev)
    engine.make_fitness_fn = spy
    try:
        t0 = time.perf_counter()
        run_es(x, y, SR, chain, model, **common)  # warm-up block
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        phase_timer.reset(True)
        launch_counts(reset=True)
        t0 = time.perf_counter()
        res = run_es(x, y, SR, chain, model, **common)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        spans = phase_timer.read_ms()
        phase_timer.reset(False)
    finally:
        engine.make_fitness_fn = real
    peak = torch.cuda.max_memory_allocated()
    mb = picked[-1] or POP_LONG
    subs = POP_LONG // mb
    want = {k: GENS_LONG * subs if k in ("k1", "k9") else 0
            for k in launches}
    if launches != want:
        raise AssertionError(f"long: launches {launches} in {GENS_LONG} "
                             f"generations of {subs} sub-batches; expected "
                             f"{want}")
    hist = np.asarray(res["fval_history"])
    out = res["output_audio"]
    if hist.shape != (GENS_LONG,) or not np.isfinite(hist).all():
        raise AssertionError(f"long: fitness history {hist}")
    if out.shape != (1, 2, T_LONG) or not torch.isfinite(out).all():
        raise AssertionError("long: output audio is not finite (1, 2, T)")
    # the output render (per candidate, plain PyTorch, outside
    # time_elapsed) once more, timed, on run_es's peak-normalised input
    xn = x / x.abs().max()
    again, render_ms = once_ms(lambda: render(
        torch.as_tensor(res["wopt"], dtype=torch.float32), xn[0]))
    render_err = float((again - out[0]).abs().max())
    if render_err > 1e-5:
        raise AssertionError(f"long: the output render differs: "
                             f"{render_err}")
    n_fft = next_pow2(T_LONG + min(T_LONG, 10 * SR))
    # the (38, F) reverb table at n 2^22 (319 MB) is built once and kept
    built = [key for key in k9._TABLES if key[2] == n_fft]
    if len(built) != 1:
        raise AssertionError(f"long: rp tables at n {n_fft}: {built}")
    per_cand = (peak - base) / mb
    rec.update(
        sub_batch=mb, sub_batches=subs, launches=launches, warm_up_s=warm,
        wall_s=wall, evals_per_sec=res["evals_per_sec"],
        ms_per_generation=1e3 * res["time_elapsed"] / GENS_LONG,
        phase_ms_per_generation={k: sum(v) / GENS_LONG
                                 for k, v in spans.items()},
        max_memory_allocated_bytes=peak, allocated_before_bytes=base,
        peak_bytes_per_candidate=per_cand, n_fft=n_fft,
        peak_bytes_per_candidate_fft_sample=per_cand / n_fft,
        output_render_ms=render_ms, output_render_err=render_err,
        fval_history=hist.tolist())
    log(f"long (60 s, popsize {POP_LONG}, sub-batch {mb}): "
        f"{res['evals_per_sec']!r} evals/s, {rec['ms_per_generation']!r} "
        f"ms/generation, launches {launches}; warm-up block {warm!r} s")
    log("per-phase device ms per generation (long): "
        + json.dumps(rec["phase_ms_per_generation"]))
    log(f"long: max_memory_allocated {peak} bytes, {base} before the "
        f"block: {per_cand!r} bytes a candidate, {per_cand / n_fft!r} a "
        f"sample of the 2^{n_fft.bit_length() - 1} FFT grid")
    log(f"long: output render (per candidate, T {T_LONG}) {render_ms!r} "
        f"ms; fitness history {hist.tolist()}")
    del res, out, again, y
    torch.cuda.empty_cache()

    # K1 at the long path's lanes and chunk length
    lanes = 2 * mb
    L = eqcomp.chunk_len(lanes, T_LONG)
    head = k1_inputs(mb, 2, T_LONG, 12, True, dev)
    rec["k1_ms"] = cuda_ms(lambda: eqcomp.eqcomp_cuda(*head), 3)
    rec["k1_chunk"] = L
    rec["k1_bound_ms"] = max(
        4 * (lanes * T_LONG + head[0].numel() + head[1].numel())
        / HBM_BYTES_PER_S,
        K1_OPS_PER_SAMPLE * lanes * T_LONG / FP32_OPS_PER_S) * 1e3
    log(f"K1 long (lanes {lanes}, T {T_LONG}, chunk {L}, "
        f"{-(-T_LONG // L)} chunks): {rec['k1_ms']!r} ms, bound "
        f"{rec['k1_bound_ms']!r}")
    del head
    path = _build.BUILD_DIR.parent / "k1_long_plain64.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    job = spawn(k1_plain64_job, str(path), mb, T_K1_LONG, 12, True)
    try:
        args = k1_inputs(mb, 2, T_K1_LONG, 12, True, dev)
        rec["k1_max_abs_err"], rec["k1_plain_ms"] = k1_check(
            args, f"long chunk {L}, B {mb}, T {T_K1_LONG}, shared=True",
            want64=lambda: await_saved(str(path), job), L=L)
    finally:
        stop(job)

    # K9 at n 2^22 and the sub-batch
    case = k9_case(mb, n_fft, 13, dev)
    if case[2] is not k9._TABLES[built[0]]:
        raise AssertionError("long: K9's check built its tables again")
    rec["k9_max_abs_err"], rec["k9_max_rel_err"], rec["k9_plain_ms"] = \
        k9_check(case, f"long n 2^{n_fft.bit_length() - 1}, B {mb}")
    rec["k9_ms"] = cuda_ms(lambda: k9.packed_response_cuda(*case[0],
                                                           *case[1:]), 5)
    F = n_fft // 2 + 1
    rec["k9_bound_ms"] = max(
        4 * (8 * mb * F + case[2]["reverb"]["_packed"].numel() + 9 * mb)
        / HBM_BYTES_PER_S, K9_OPS_PER_BIN * mb * F / FP32_OPS_PER_S) * 1e3
    log(f"K9 long (B {mb}, F {F}): {rec['k9_ms']!r} ms, bound "
        f"{rec['k9_bound_ms']!r}")
    del case
    torch.cuda.empty_cache()
    return launches


def phase_multitrack(dev, model, rec):
    """``run_es_multitrack``: 4 tracks x popsize 128 at the headline T; a
    warm-up generation, then 2 generations whose launches must be K1 (on
    per-candidate input), K3 and K4 once per generation and once more for
    the final batched render, no other kernel."""
    from st_ito_torch.chain import basic_chain
    from st_ito_torch.ito import run_es_multitrack
    from st_ito_torch.utils import phase_timer

    chain = basic_chain()
    x = torch.cat([program_audio(20 + t, T_HEAD) for t in range(TRACKS)])
    y = torch.cat([styled_target(x[t:t + 1], chain, dev, 30 + t)
                   for t in range(TRACKS)])
    t0 = time.perf_counter()
    run_es_multitrack(x, y, SR, chain, model, max_iters=1,
                      popsize=POP_TRACK, device=dev)  # warm-up
    torch.cuda.synchronize()
    log(f"multitrack warm-up (1 generation): {time.perf_counter() - t0!r} s")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    phase_timer.reset(True)
    launch_counts(reset=True)
    res = run_es_multitrack(x, y, SR, chain, model, max_iters=GENS,
                            popsize=POP_TRACK, device=dev)
    torch.cuda.synchronize()
    launches = launch_counts()
    spans = phase_timer.read_ms()
    phase_timer.reset(False)
    want = {k: GENS + 1 if k in ("k1", "k3", "k4") else 0 for k in launches}
    if launches != want:
        raise AssertionError(f"multitrack: launches {launches}; expected "
                             f"{want}")
    hist = np.asarray(res["fval_history"])
    out = res["output_audio"]
    if hist.shape != (TRACKS, GENS) or not np.isfinite(hist).all():
        raise AssertionError(f"multitrack: fitness history {hist}")
    if out.shape != (TRACKS, 2, T_HEAD) or not torch.isfinite(out).all():
        raise AssertionError("multitrack: output audio is not finite "
                             "(tracks, 2, T)")
    rec.update(evals_per_sec=res["evals_per_sec"],
               ms_per_generation=1e3 * res["time_elapsed"] / GENS,
               phase_ms_per_generation={k: sum(v) / GENS
                                        for k, v in spans.items()},
               launches=launches, fval_history=hist.tolist(),
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    log(f"multitrack ({TRACKS} tracks x popsize {POP_TRACK}): "
        f"{res['evals_per_sec']!r} evals/s, {rec['ms_per_generation']!r} "
        f"ms/generation, launches {launches}")
    log("per-phase device ms per generation (multitrack, spans of the "
        "final render included): " + json.dumps(
            rec["phase_ms_per_generation"]))
    log(f"max_memory_allocated (multitrack): "
        f"{rec['max_memory_allocated_bytes']} bytes; fitness "
        f"{hist.tolist()}")
    return launches


def phase_dtype(dev, model, rec):
    from st_ito_torch.chain import basic_chain
    from st_ito_torch.ito import make_fitness_fn
    from st_ito_torch.models import get_param_embeds

    chain = basic_chain()
    x = program_audio(5, T_HEAD)
    x = (x / x.abs().max()).to(dev)
    y = styled_target(x.cpu(), chain, dev, 6)
    target = get_param_embeds(y, model, SR)
    W = np.random.default_rng(7).random((64, chain.num_params))
    v32 = make_fitness_fn(chain, model, SR, 2, compute_dtype="float32",
                          device=dev)(W, x[0], target).cpu().numpy()
    v16 = make_fitness_fn(chain, model, SR, 2, compute_dtype="bfloat16",
                          device=dev)(W, x[0], target).cpu().numpy()
    delta = float(np.abs(v32 - v16).max())
    r32 = np.argsort(np.argsort(v32))
    r16 = np.argsort(np.argsort(v16))
    rho = float(np.corrcoef(r32, r16)[0, 1])
    log(f"bf16 vs f32 fitness (pop 64): max |delta| {delta!r}, Spearman "
        f"{rho!r}, f32 range [{v32.min()!r}, {v32.max()!r}]")
    rec.update(max_abs_delta=delta, spearman=rho,
               f32_min=float(v32.min()), f32_max=float(v32.max()))
    if not (np.isfinite(v32).all() and np.isfinite(v16).all()):
        raise AssertionError("non-finite fitness")
    if delta >= 0.02 or rho <= 0.95:
        raise AssertionError(f"bf16 fitness disagrees: {delta}, {rho}")


# ------------------------------------------- gradient ITO, fast=False, eval


def no_launches(label, launches):
    """Hold that a path launched no kernel."""
    if any(launches.values()):
        raise AssertionError(f"{label}: launches {launches}; expected none")


def autodiff_cli_run(dev, tmp, wav, name, iters, flags):
    """``run_optim.main`` with ``--algorithm autodiff`` and the synthetic
    target (the 51-parameter processor at the JAX CLI's w_target) on
    ``wav`` at the default --max-length: no kernel launched; the loss
    history finite, the WAV (2, T_HEAD) and the 51 parameters written.
    Returns (result, wall s, peak bytes)."""
    from st_ito_torch.cli import run_optim
    from st_ito_torch.utils import load_audio

    out_dir = os.path.join(tmp, name)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    launch_counts(reset=True)
    t0 = time.perf_counter()
    res = run_optim.main([wav, "None", "--algorithm", "autodiff",
                          "--max-iters", str(iters), "--allow-random-model",
                          "--output-dir", out_dir, "--device", dev.type]
                         + flags)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    no_launches(f"autodiff cli {name}", launch_counts())
    run_dir = os.path.join(out_dir, "program_to_synthetic_target_autodiff")
    audio, sr = load_audio(os.path.join(run_dir,
                                        "output_audio_sigma=0.33.wav"))
    with open(os.path.join(run_dir, "parameters_sigma=0.33.json")) as f:
        params = json.load(f)
    hist = np.asarray(res["fval_history"])
    if (sr != SR or audio.shape != (2, T_HEAD)
            or not np.isfinite(audio).all() or len(params) != 51
            or not np.isfinite(list(params.values())).all()
            or hist.shape != (iters,) or not np.isfinite(hist).all()):
        raise AssertionError(f"autodiff cli {name}: the output WAV, the "
                             f"parameter JSON or the loss history is not "
                             f"finite at the expected shape")
    log(f"autodiff cli {name} ({iters} iterations"
        f"{', ' + ' '.join(flags) if flags else ''}): "
        f"{1e3 * res['time_elapsed'] / iters!r} ms/iteration, {wall!r} s "
        f"wall, peak {peak} bytes, loss {hist.tolist()}")
    return res, wall, peak


def phase_autodiff(dev, model, rec):
    """Gradient ITO at full width: the CLI's ``--algorithm autodiff`` (the
    51-parameter processor and the deployed Cnn14 in float32, forward and
    backward) for a warm-up iteration and AD_ITERS timed ones, and again
    with ``--metric mfcc``, whose loss must fall; ``run_autodiff`` through
    the basic chain's per-candidate renderer for a warm-up and AD_ITERS
    iterations; no kernel launched in any of them. Then the first step's
    loss and gradient (theta = 0) on the card against the same step run
    by the port on the CPU: the loss within 1e-5 relative, the gradient
    within 1e-3 in relative L2 (TF32 in the backward pass would miss it)."""
    import tempfile

    from st_ito_torch import proc
    from st_ito_torch.chain import basic_chain
    from st_ito_torch.cli.run_optim import synthetic_autodiff_target_params
    from st_ito_torch.ito import engine, run_autodiff
    from st_ito_torch.models import load_param_model
    from st_ito_torch.utils import save_audio

    x = program_audio(3, T_HEAD)
    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "program.wav")
        save_audio(wav, x[0], SR)
        autodiff_cli_run(dev, tmp, wav, "warm-up", 1, [])
        res, wall, peak = autodiff_cli_run(dev, tmp, wav, "param", AD_ITERS,
                                           [])
        rec["cli"] = dict(ms_per_iteration=1e3 * res["time_elapsed"]
                          / AD_ITERS, wall_s=wall,
                          max_memory_allocated_bytes=peak,
                          fval_history=res["fval_history"])
        res, wall, peak = autodiff_cli_run(dev, tmp, wav, "mfcc", AD_ITERS,
                                           ["--metric", "mfcc"])
        hist = res["fval_history"]
        rec["mfcc"] = dict(ms_per_iteration=1e3 * res["time_elapsed"]
                           / AD_ITERS, wall_s=wall,
                           max_memory_allocated_bytes=peak,
                           fval_history=hist)
        if not hist[-1] < hist[0]:
            raise AssertionError(f"autodiff --metric mfcc: the loss did not "
                                 f"fall: {hist}")

    chain = basic_chain()
    y = styled_target(x, chain, dev, 50)
    common = dict(chain=chain, lr=1e-2, verbose=False, device=dev)
    run_autodiff(x, y, SR, model, n_iters=1, **common)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    launch_counts(reset=True)
    res = run_autodiff(x, y, SR, model, n_iters=AD_ITERS, **common)
    torch.cuda.synchronize()
    no_launches("run_autodiff (basic chain)", launch_counts())
    hist = np.asarray(res["fval_history"])
    out = res["output_audio"]
    if (not np.isfinite(hist).all() or out.shape != (1, 2, T_HEAD)
            or not torch.isfinite(out).all()):
        raise AssertionError(f"run_autodiff (basic chain): loss {hist}")
    rec["chain"] = dict(ms_per_iteration=1e3 * res["time_elapsed"]
                        / AD_ITERS,
                        max_memory_allocated_bytes=(
                            torch.cuda.max_memory_allocated()),
                        fval_history=hist.tolist())
    log(f"run_autodiff (basic chain, {AD_ITERS} iterations): "
        f"{rec['chain']['ms_per_iteration']!r} ms/iteration, peak "
        f"{rec['chain']['max_memory_allocated_bytes']} bytes, loss "
        f"{hist.tolist()}")

    # the first step on the card and on the CPU: the CLI's input and target
    w_target = torch.from_numpy(synthetic_autodiff_target_params())
    with torch.no_grad():
        y = proc.apply_complex_autodiff_processor(
            x.to(dev), w_target.to(dev)[None], SR)
    steps = {}
    for where, m in (("card", model), ("cpu", load_param_model(
            allow_random=True, seed=0, device="cpu"))):
        d = dev if where == "card" else torch.device("cpu")
        fn, P, _ = engine.autodiff_loss_fn(x.to(d), y.to(d), SR, m, device=d)
        theta = torch.zeros(P, device=d, requires_grad=True)
        t0 = time.perf_counter()
        loss = engine.autodiff_step(fn, theta)
        steps[where] = (loss.item(), theta.grad.double().cpu(),
                        time.perf_counter() - t0)
    (l_card, g_card, _), (l_cpu, g_cpu, s_cpu) = steps["card"], steps["cpu"]
    rel = float(torch.linalg.norm(g_card - g_cpu) / torch.linalg.norm(g_cpu))
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    worst = int(torch.argmax((g_card - g_cpu).abs()))
    rec["first_step"] = dict(loss_card=l_card, loss_cpu=l_cpu,
                             loss_rel=loss_rel, grad_rel_l2=rel,
                             grad_norm=float(torch.linalg.norm(g_cpu)),
                             worst_component=worst, cpu_s=s_cpu)
    log(f"autodiff first step, card against CPU: loss {l_card!r} / "
        f"{l_cpu!r} (relative {loss_rel!r}), gradient relative L2 {rel!r} "
        f"(norm {rec['first_step']['grad_norm']!r}; worst component "
        f"{worst}: {float(g_card[worst])!r} / {float(g_cpu[worst])!r}); the "
        f"CPU step took {s_cpu!r} s")
    if not (torch.isfinite(g_card).all() and torch.isfinite(g_cpu).all()
            and math.isfinite(l_card)):
        raise AssertionError("autodiff: a loss or gradient is not finite")
    if rel > 1e-3 or loss_rel > 1e-5:
        raise AssertionError(f"autodiff: the card's first step lies "
                             f"{rel} (gradient, relative L2) and {loss_rel} "
                             f"(loss) from the CPU's")


def phase_nofast(dev, model, rec):
    """The differentiable renderer (``fast=False``) inside the ES loop:
    one device block of the CMA-ES (``device_es``, as ``run_es`` runs it
    at gens_per_dispatch > 1) of the basic chain at popsize 512 through
    ``make_fitness_fn(renderer_fast=False)``, a warm-up and a timed block
    of GENS generations, which must launch no kernel. Then 8 candidates of
    its render on the card against the same render on the CPU (atol 1e-4 x
    peak), and their distance from the fast renderer's."""
    from st_ito_torch.chain import basic_chain, build_batched_render_fn
    from st_ito_torch.ito import device_es, make_fitness_fn
    from st_ito_torch.models import get_param_embeds
    from st_ito_torch.utils import phase_timer

    chain = basic_chain()
    x = program_audio(0, T_HEAD)[0].to(dev)
    x = x / x.abs().max()
    target = get_param_embeds(styled_target(x[None].cpu(), chain, dev, 1),
                              model, SR)
    fitness = make_fitness_fn(chain, model, SR, 2, renderer_fast=False,
                              device=dev)
    consts = device_es.cma_consts(chain.num_params, POP, dev)
    runner = device_es.make_block_runner(fitness, consts)

    def block():
        gen = torch.Generator(device=dev).manual_seed(0)
        state = device_es.cma_init(np.full(chain.num_params, 0.5), 0.33, dev)
        t0 = time.perf_counter()
        _, stats = runner(state, x, target, GENS, gen,
                          torch.Generator().manual_seed(0))
        stats = stats.cpu().numpy()
        return time.perf_counter() - t0, stats

    block()  # warm-up
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    phase_timer.reset(True)
    launch_counts(reset=True)
    secs, stats = block()
    launches = launch_counts()
    spans = phase_timer.read_ms()
    phase_timer.reset(False)
    no_launches("nofast", launches)
    if not np.isfinite(stats).all():
        raise AssertionError(f"nofast: block statistics {stats}")
    rec.update(ms_per_generation=1e3 * secs / GENS,
               evals_per_sec=POP * GENS / secs, launches=launches,
               phase_ms_per_generation={k: sum(v) / GENS
                                        for k, v in spans.items()},
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
               best_fitness=stats[:, 1].tolist())
    log(f"nofast (basic chain, fast=False, popsize {POP}): "
        f"{rec['ms_per_generation']!r} ms/generation, "
        f"{rec['evals_per_sec']!r} evals/s, peak "
        f"{rec['max_memory_allocated_bytes']} bytes, spans "
        + json.dumps(rec["phase_ms_per_generation"]))

    W = torch.from_numpy(np.random.default_rng(51).random(
        (NOFAST_CHECK, chain.num_params)).astype(np.float32))
    renders = {}
    for label, fast, d in (("card", False, dev), ("cpu", False, "cpu"),
                           ("fast", True, dev)):
        launch_counts(reset=True)
        renders[label] = build_batched_render_fn(
            chain, SR, 2, fast=fast, device=d)(W, x.to(d)).cpu()
        if not fast:
            no_launches(f"nofast render ({label})", launch_counts())
    peak = float(renders["cpu"].abs().max())
    err = float((renders["card"] - renders["cpu"]).abs().max())
    dist = float((renders["card"] - renders["fast"]).abs().max())
    rec.update(card_vs_cpu_max_abs_err=err, vs_fast_max_abs=dist)
    log(f"nofast render of {NOFAST_CHECK} candidates: card against CPU "
        f"max abs {err!r} (limit 1e-4 x peak {peak!r}); against the fast "
        f"renderer (frequency-sampled EQ against the exact cascade, the "
        f"tail-continuous group) max abs {dist!r}")
    if not err <= 1e-4 * max(1.0, peak):
        raise AssertionError(f"nofast: the card's render lies {err} from "
                             f"the CPU's")


def phase_eval(dev, model, rec):
    """The recovery evaluations on the card: ``run_synthetic_benchmark``
    on the basic chain with ``run_es`` (popsize 64, EVAL_ES_GENS
    generations: K1, K3 and K4 each generation) and ``run_autodiff``
    (EVAL_AD_ITERS iterations) under the param metric; the ``eval_psm``
    CLI on EVAL_PSM_EXAMPLES examples, ``eval_sweep`` on the distortion's
    drive at EVAL_SWEEP_STEPS points and ``effect_info --test`` on the
    reverb. Every score finite and every JSON written."""
    import tempfile

    from st_ito_torch.chain import basic_chain
    from st_ito_torch.cli import effect_info, eval_psm, eval_sweep
    from st_ito_torch.eval.synthetic import run_synthetic_benchmark
    from st_ito_torch.ito import run_autodiff, run_es
    from st_ito_torch.models import get_param_embeds

    chain = basic_chain()
    x = program_audio(60, T_HEAD)[0]
    methods = {
        "es": {"func": run_es, "kwargs": dict(
            chain=chain, model=model, popsize=EVAL_ES_POP,
            max_iters=EVAL_ES_GENS, find_w0=False, verbose=False,
            device=dev)},
        "autodiff": {"func": run_autodiff, "kwargs": dict(
            model=model, chain=chain, n_iters=EVAL_AD_ITERS, verbose=False,
            device=dev)}}
    with tempfile.TemporaryDirectory() as tmp:
        launch_counts(reset=True)
        t0 = time.perf_counter()
        out = os.path.join(tmp, "synthetic.json")
        res = run_synthetic_benchmark(chain, x, methods, model,
                                      get_param_embeds, SR, out_path=out,
                                      device=dev)
        rec["synthetic_s"] = time.perf_counter() - t0
        launches = launch_counts()
        with open(out) as f:
            written = json.load(f)
        scores = [v for case in res.values() for m in ("es", "autodiff")
                  for v in case[m].values()]
        if len(res) != 6 or written.keys() != res.keys() or not np.isfinite(
                scores).all():
            raise AssertionError(f"eval synthetic: {res}")
        want = {k: 6 * EVAL_ES_GENS if k in ("k1", "k3", "k4") else 0
                for k in launches}
        if launches != want:
            raise AssertionError(f"eval synthetic: launches {launches}; "
                                 f"expected {want}")
        rec["synthetic"] = {name: {m: case[m] for m in ("es", "autodiff")}
                            for name, case in res.items()}
        log(f"eval synthetic (6 cases; run_es at popsize {EVAL_ES_POP}, "
            f"{EVAL_ES_GENS} generations; run_autodiff, {EVAL_AD_ITERS} "
            f"iterations): {rec['synthetic_s']!r} s, launches {launches}, "
            + json.dumps(rec["synthetic"]))

        t0 = time.perf_counter()
        out = os.path.join(tmp, "psm.json")
        psm = eval_psm.main(["--metrics", "param", "--num-examples",
                             str(EVAL_PSM_EXAMPLES), "--allow-random-model",
                             "--out", out, "--device", dev.type])
        with open(out) as f:
            written = json.load(f)
        accs = [a for cond in psm.values() for m in cond.values()
                for a in m["accuracy_by_distractors"].values()]
        if set(written) != {"intra-effect", "inter-effect"} or not (
                np.isfinite(accs).all()):
            raise AssertionError(f"eval_psm: {psm}")
        rec["psm"] = psm
        rec["psm_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        out = os.path.join(tmp, "sweep.json")
        sweep = eval_sweep.main(["--effect", "distortion", "--param",
                                 "drive_db", "--num-steps",
                                 str(EVAL_SWEEP_STEPS),
                                 "--allow-random-model", "--out", out,
                                 "--device", dev.type])
        with open(out) as f:
            written = json.load(f)
        if (len(written["similarities"]) != EVAL_SWEEP_STEPS
                or not np.isfinite(sweep["similarities"]).all()):
            raise AssertionError(f"eval_sweep: {sweep}")
        rec["sweep"] = sweep
        rec["sweep_s"] = time.perf_counter() - t0

    stats = effect_info.main(["reverb", "--test", "--device", dev.type])
    if not (stats["finite"] and np.isfinite(list(stats.values())).all()):
        raise AssertionError(f"effect_info: {stats}")
    rec["effect_info"] = stats
    log(f"eval_psm ({EVAL_PSM_EXAMPLES} examples) {rec['psm_s']!r} s: "
        f"{json.dumps(psm)}; eval_sweep ({EVAL_SWEEP_STEPS} points) "
        f"{rec['sweep_s']!r} s: monotonicity {sweep['monotonicity']!r}; "
        f"effect_info reverb: {stats}")


def encoder_cases(dev):
    """(name, the model on dev, embed_fn) of each baseline encoder at its
    published config with random weights."""
    from st_ito_torch.models import (get_beats_embeds, get_fx_encoder_embeds,
                                     get_vggish_embeds, get_wav2clip_embeds,
                                     load_beats_model, load_fx_encoder_model,
                                     load_vggish_model, load_wav2clip_model)

    return [
        ("fx-encoder", load_fx_encoder_model(None, allow_random=True,
                                             device=dev),
         get_fx_encoder_embeds),
        ("vggish", load_vggish_model(None, None, allow_random=True,
                                     device=dev), get_vggish_embeds),
        ("wav2clip", load_wav2clip_model(None, allow_random=True,
                                         device=dev), get_wav2clip_embeds),
        ("beats", load_beats_model(None, allow_random=True, device=dev),
         get_beats_embeds)]


def min_cosine(got: dict, want: dict) -> float:
    """The least cosine over the items of every head."""
    from st_ito_torch.eval.metrics import cosine

    return min(float(cosine(got[k].cpu().double(),
                            want[k].double()).min()) for k in want)


def phase_pst(dev, rec):
    """The PST benchmark, the baseline encoders, style classification, the
    embed CLI and the .ckpt converter (the module docstring's item 19)."""
    import copy
    import dataclasses
    import glob
    import importlib.util
    import tempfile

    import st_ito_torch.ito as ito
    from st_ito_torch.chain import chain_preset
    from st_ito_torch.cli import embed, eval_cls, eval_pst
    from st_ito_torch.eval.pst import default_methods, run_pst_benchmark
    from st_ito_torch.models import (Cnn14, Cnn14Config, ParamModel,
                                     get_param_embeds, load_param_model)
    from st_ito_torch.models.cnn14 import init_cnn14_

    t_phase = time.perf_counter()
    generations = []
    run_es = ito.run_es

    def counted_run_es(*a, **k):
        out = run_es(*a, **k)
        generations.append((len(out["fval_history"]), out["time_elapsed"]))
        return out

    with tempfile.TemporaryDirectory() as tmp:
        # 1. the PST benchmark CLI at its defaults
        out_dir = os.path.join(tmp, "pst")
        ito.run_es = counted_run_es
        try:
            launch_counts(reset=True)
            t0 = time.perf_counter()
            res = eval_pst.main(["--allow-random-model", "--output-dir",
                                 out_dir, "--device", dev.type])
            torch.cuda.synchronize()
            rec["eval_pst_s"] = time.perf_counter() - t0
            launches = launch_counts()
        finally:
            ito.run_es = run_es
        gens = sum(g for g, _ in generations)
        want = {k: gens if k in ("k1", "k3", "k4") else 0 for k in launches}
        if len(generations) != 2 or launches != want:
            raise AssertionError(
                f"eval_pst: launches {launches} over style-es runs of "
                f"{generations} generations; expected {want}")
        methods = ("input", "random", "rule-based", "style-es")
        sims = {ex: {m: {k: v for k, v in e.items() if k.endswith("_sim")}
                     for m, e in per.items()} for ex, per in res.items()}
        flat = [v for per in sims.values() for e in per.values()
                for v in e.values()]
        if (set(res) != {"synthetic0", "synthetic1"}
                or any(list(per) != list(methods) for per in res.values())
                or len(flat) != 2 * len(methods) * 2
                or not np.isfinite(flat).all()):
            raise AssertionError(f"eval_pst: {sims}")
        if len(glob.glob(os.path.join(out_dir, "results_*.json"))) != 1:
            raise AssertionError("eval_pst wrote no results JSON")
        # each method's output, and the input and the target
        want_wavs = sorted({f"{n}.wav" for n in (*methods, "target")})
        for ex in res:
            wavs = sorted(os.listdir(os.path.join(out_dir, ex)))
            if wavs != want_wavs:
                raise AssertionError(f"eval_pst {ex}: WAVs {wavs}")
        plotted = os.path.isfile(os.path.join(out_dir, "pst_plot.png"))
        if plotted != (importlib.util.find_spec("matplotlib") is not None):
            raise AssertionError(f"eval_pst: pst_plot.png written {plotted}")
        rec.update(
            launches=launches, sims=sims, pst_plot_written=plotted,
            style_es_generations=[g for g, _ in generations],
            ms_per_style_es_generation=[1e3 * t / g for g, t in generations],
            method_s={ex: {m: e["time_elapsed"] for m, e in per.items()}
                      for ex, per in res.items()})
        log(f"eval_pst at its defaults: {rec['eval_pst_s']!r} s, launches "
            f"{launches} ({rec['style_es_generations']} style-es "
            f"generations), ms per style-es generation "
            f"{rec['ms_per_style_es_generation']}, s per method "
            f"{json.dumps(rec['method_s'])}, pst_plot.png written "
            f"{plotted}; similarities {json.dumps(sims)}")

        # 2. the baseline encoders on the card against their CPU runs
        x = torch.cat([program_audio(70 + i, T_HEAD)
                       for i in range(max(ENCODER_CHECK_B,
                                          *ENCODER_TIMED_B))]).to(dev)
        metrics, enc = {}, {}
        for name, model, embed_fn in encoder_cases(dev):
            r = enc[name] = {}
            cpu_model = dataclasses.replace(
                model, net=copy.deepcopy(model.net).cpu())
            batch = x[:ENCODER_CHECK_B]
            got = embed_fn(batch, model, SR)
            want = embed_fn(batch.cpu(), cpu_model, SR)
            r["min_cosine"] = min_cosine(got, want)
            if not r["min_cosine"] > 1.0 - ENCODER_COS:
                raise AssertionError(
                    f"{name}: the card's embeddings lie at cosine "
                    f"{r['min_cosine']!r} of the CPU's")
            del cpu_model
            # the embed's own peak: above what is allocated before it (the
            # four encoders' weights, the audio)
            for b in ENCODER_TIMED_B:
                torch.cuda.empty_cache()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                r[f"ms_b{b}"] = cuda_ms(
                    lambda b=b: embed_fn(x[:b], model, SR), 3)
                r[f"peak_bytes_b{b}"] = (torch.cuda.max_memory_allocated()
                                         - base)
            r["weight_bytes"] = sum(
                t.numel() * t.element_size() for t in
                (*model.net.parameters(), *model.net.buffers()))
            r["dims"] = {k: int(v.shape[-1]) for k, v in got.items()}
            metrics[name] = (model, embed_fn)
            log(f"encoder {name}: min cosine to the CPU "
                f"{r['min_cosine']!r}, weights {r['weight_bytes']} bytes, "
                f"embed ms and peak bytes at batches {ENCODER_TIMED_B}: "
                + ", ".join(f"{r[f'ms_b{b}']!r} ms, {r[f'peak_bytes_b{b}']}"
                            for b in ENCODER_TIMED_B)
                + f"; heads {r['dims']}")
        chain = chain_preset("general")
        example = eval_pst._synth_examples(chain, n=1, device=dev)
        all_methods = default_methods(chain, None, get_param_embeds,
                                      device=dev)
        launch_counts(reset=True)
        t0 = time.perf_counter()
        res = run_pst_benchmark(example, {m: all_methods[m] for m in (
            "input", "rule-based")}, metrics, device=dev)
        rec["encoders_benchmark_s"] = time.perf_counter() - t0
        no_launches("pst encoders", launch_counts())
        enc_sims = {m: {k: v for k, v in e.items() if k.endswith("_sim")}
                    for m, e in res["synthetic0"].items()}
        flat = [v for e in enc_sims.values() for v in e.values()]
        if len(flat) != 2 * len(metrics) or not np.isfinite(flat).all():
            raise AssertionError(f"pst encoders: {enc_sims}")
        rec.update(encoders=enc, encoder_sims=enc_sims)
        log(f"run_pst_benchmark with the four encoders (input, rule-based): "
            f"{rec['encoders_benchmark_s']!r} s, {json.dumps(enc_sims)}")
        del metrics, x
        torch.cuda.empty_cache()

        # 3. style classification at its defaults
        out = os.path.join(tmp, "cls.json")
        launch_counts(reset=True)
        t0 = time.perf_counter()
        cls_res = eval_cls.main(["--allow-random-model", "--out", out,
                                 "--device", dev.type])
        rec["eval_cls_s"] = time.perf_counter() - t0
        no_launches("eval_cls", launch_counts())
        with open(out) as f:
            written = json.load(f)
        accs = [v for m in cls_res.values() for k, v in m.items()
                if k.endswith("_acc")]
        if written != cls_res or set(cls_res) != {"param", "mfcc"} or not (
                len(accs) == 4 and all(0.0 <= a <= 1.0 for a in accs)):
            raise AssertionError(f"eval_cls: {cls_res}")
        rec["cls"] = cls_res
        log(f"eval_cls at its defaults: {rec['eval_cls_s']!r} s, "
            f"{json.dumps(cls_res)}")

        # 4. the embed CLI, and the .ckpt converter on a Lightning
        # checkpoint of a random Cnn14 written here
        launch_counts(reset=True)
        e = embed.main(["--allow-random", "--device", dev.type])
        no_launches("embed", launch_counts())
        if set(e) != {"mid", "side"} or not all(
                torch.isfinite(v).all() and v.shape[0] == 1
                for v in e.values()):
            raise AssertionError(f"embed: {e}")
        cfg = Cnn14Config()
        src = ParamModel(net=init_cnn14_(Cnn14(cfg), torch.Generator()
                                         .manual_seed(5)).to(dev),
                         config=cfg)
        path = os.path.join(tmp, "afx-rep.ckpt")
        torch.save({"state_dict": {f"encoder.{k}": v.cpu() for k, v in
                                   src.net.state_dict().items()}}, path)
        conv = load_param_model(path, device=dev)
        if not os.path.isfile(os.path.join(tmp, "afx-rep.npz")):
            raise AssertionError("the .ckpt was not cached as .npz")
        x_ckpt = program_audio(80, T_HEAD).to(dev)
        got, want = (get_param_embeds(x_ckpt, m, SR) for m in (conv, src))
        rec["ckpt_max_abs_err"] = max(float((got[k] - want[k]).abs().max())
                                      for k in want)
        if not rec["ckpt_max_abs_err"] <= CKPT_TOL:
            raise AssertionError(
                f".ckpt round trip: {rec['ckpt_max_abs_err']!r}")
        log(f"embed CLI: mid {e['mid'][0, :4].tolist()}; the .ckpt "
            f"converter's embeddings within {rec['ckpt_max_abs_err']!r} "
            f"of the source model's")
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"pst phase: {rec['phase_s']!r} s")
    return rec["launches"]


def shared_knn(run):
    """(run's result, the k-NN picks of every DeepGCN graph conv in it) with
    ``gcn.knn_indices`` recorded; ``replay`` picks serve a later run those
    picks in the same order, wherever its tensors lie."""
    from st_ito_torch.models import gcn

    real, picks = gcn.knn_indices, []

    def record(feat, cand, k):
        picks.append(real(feat, cand, k))
        return picks[-1]

    gcn.knn_indices = record
    try:
        return run(), picks
    finally:
        gcn.knn_indices = real


def replay_knn(run, picks):
    """run() with ``gcn.knn_indices`` serving ``picks`` in order; returns
    (run's result, the nodes whose own picks differ from those served,
    their largest k-th/(k+1)-th relative gap of float64 distances, the
    largest share of a graph conv's nodes that differ). Raises where a
    node differs but holds no near tie (KNN_TIE) or a conv's share passes
    KNN_FLIP_SHARE."""
    from st_ito_torch.models import gcn

    real, order, flips, worst, share = gcn.knn_indices, iter(picks), [0], \
        [0.0], [0.0]

    def serve(feat, cand, k):
        given = next(order).to(feat.device)
        own = real(feat, cand, k)
        flipped = (own.sort(-1).values != given.sort(-1).values).any(-1)
        if flipped.any():
            d = torch.cdist(feat.transpose(1, 2).double(),
                            cand.transpose(1, 2).double()) ** 2
            top = -torch.topk(-d, k + 1, dim=-1).values
            gaps = ((top[..., k] - top[..., k - 1])
                    / top[..., k].clamp_min(1e-300))[flipped]
            flips[0] += int(flipped.sum())
            worst[0] = max(worst[0], float(gaps.max()))
            share[0] = max(share[0], float(flipped.double().mean()))
            if not (worst[0] < KNN_TIE and share[0] <= KNN_FLIP_SHARE):
                raise AssertionError(
                    f"gcn: {int(flipped.sum())} nodes' k-NN picks differ "
                    f"from the card's, gaps up to {worst[0]!r}, a share "
                    f"{share[0]!r} of the conv's nodes")
        return given

    gcn.knn_indices = serve
    try:
        return run(), flips[0], worst[0], share[0]
    finally:
        gcn.knn_indices = real


def phase_clap(dev, rec):
    """The LAION-CLAP metric and the training backbones (the module
    docstring's item 20)."""
    import contextlib
    import copy
    import tempfile

    import st_ito_torch.models.clap_laion as clap_laion_mod
    from st_ito_torch.models import clap, gcn, htsat
    from st_ito_torch.models.clap_laion import (ClapAudioTower,
                                                ClapLaionConfig,
                                                get_clap_laion_embeds_midside,
                                                init_clap_laion_,
                                                load_clap_laion_model)
    from st_ito_torch.utils import save_audio

    t_phase = time.perf_counter()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the tower at its published config, random weights written
        # under transformers' names where the CLI's loader looks
        cfg = ClapLaionConfig()
        ckpt = os.path.join(tmp, "checkpoints", "clap-htsat-unfused.pt")
        os.makedirs(os.path.dirname(ckpt))
        torch.save(init_clap_laion_(ClapAudioTower(cfg), torch.Generator()
                                    .manual_seed(14)).state_dict(), ckpt)
        model = load_clap_laion_model(ckpt, device=dev)
        cpu_model = load_clap_laion_model(ckpt, device="cpu")
        x = torch.cat([program_audio(90 + i, T_HEAD)
                       for i in range(max(ENCODER_CHECK_B,
                                          *ENCODER_TIMED_B))]).to(dev)
        batch = x[:ENCODER_CHECK_B]
        tower = rec["tower"] = {}
        got = get_clap_laion_embeds_midside(batch, model, SR)
        want = get_clap_laion_embeds_midside(batch.cpu(), cpu_model, SR)
        tower["min_cosine"] = min_cosine(got, want)
        if not tower["min_cosine"] > 1.0 - CLAP_COS:
            raise AssertionError(f"clap: the card's embeddings lie at cosine "
                                 f"{tower['min_cosine']!r} of the CPU's")
        # the limit sees TF32: the same forward with TF32 let through
        flags = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        guard = clap_laion_mod.no_tf32
        clap_laion_mod.no_tf32 = contextlib.nullcontext
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            tf32 = get_clap_laion_embeds_midside(batch, model, SR)
        finally:
            clap_laion_mod.no_tf32 = guard
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = flags
        tower["tf32_min_cosine"] = min_cosine(tf32, want)
        tower["tf32_max_abs_err"] = max(
            float((tf32[k].cpu() - want[k]).abs().max()) for k in want)
        if tower["tf32_min_cosine"] > 1.0 - CLAP_COS:
            raise AssertionError(f"clap: a TF32 forward lies at cosine "
                                 f"{tower['tf32_min_cosine']!r} of the CPU's,"
                                 f" inside the limit")
        del cpu_model, tf32
        for b in ENCODER_TIMED_B:
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            tower[f"ms_b{b}"] = cuda_ms(
                lambda b=b: get_clap_laion_embeds_midside(x[:b], model, SR), 3)
            tower[f"peak_bytes_b{b}"] = (torch.cuda.max_memory_allocated()
                                         - base)
        # the state_dict's tensors: the constant buffers are not weights
        tower["weight_bytes"] = sum(
            t.numel() * t.element_size()
            for t in model.net.state_dict().values())
        log(f"clap tower (published config, mid/side of {ENCODER_CHECK_B} x "
            f"2 x {T_HEAD}): min cosine to the CPU {tower['min_cosine']!r} "
            f"(with TF32 {tower['tf32_min_cosine']!r}, max abs error "
            f"{tower['tf32_max_abs_err']!r}), weights "
            f"{tower['weight_bytes']} bytes, embed ms and peak bytes "
            f"at batches {ENCODER_TIMED_B}: "
            + ", ".join(f"{tower[f'ms_b{b}']!r} ms, "
                        f"{tower[f'peak_bytes_b{b}']}"
                        for b in ENCODER_TIMED_B))

        # (b) the backbones at their cfg/pretext-*.yaml widths (the
        # configs' defaults): eval on the check batch against the CPU, a
        # train-mode forward at the configs' batch (autograd recording, as
        # a training step's forward does), timed, with its peak
        g = torch.Generator(device=dev).manual_seed(15)
        x_train = torch.randn((BACKBONE_TRAIN_B, 2, T_HEAD), generator=g,
                              device=dev) * 0.1
        nets = {
            "htsat": htsat.init_htsat_(htsat.HTSAT(htsat.HTSATConfig()),
                                       torch.Generator().manual_seed(16)),
            "clap-ft": clap.init_clap_audio_(
                clap.CLAPAudio(clap.CLAPAudioConfig()),
                torch.Generator().manual_seed(17)),
            "gcn": gcn.init_deepgcn_(gcn.DeepGCN(gcn.DeepGCNConfig()),
                                     torch.Generator().manual_seed(18))}
        backbones = rec["backbones"] = {}
        for name, net in nets.items():
            r = backbones[name] = {}
            cpu_net = net.eval()
            if name == "gcn":
                # random weights with BatchNorm statistics as trained ones
                # have them: a train-mode pass over the check batch with a
                # cumulative average (momentum None), on the CPU
                for m in cpu_net.modules():
                    if isinstance(m, torch.nn.BatchNorm2d):
                        m.momentum = None
                with torch.no_grad():
                    cpu_net.train()(batch.cpu())
                for m in cpu_net.modules():
                    if isinstance(m, torch.nn.BatchNorm2d):
                        m.momentum = 0.1
                cpu_net.eval()
            card_net = copy.deepcopy(cpu_net).to(dev)
            with torch.no_grad():
                if name == "gcn":
                    # the CPU aggregates the card's k-NN picks: a pick the
                    # two roundings decide apart is counted, not compared
                    got, picks = shared_knn(lambda: card_net(batch))
                    (want, r["knn_flips"], r["knn_gap"],
                     r["knn_share"]) = replay_knn(
                        lambda: cpu_net(batch.cpu()), picks)
                else:
                    got, want = card_net(batch), cpu_net(batch.cpu())
            heads = ("mid", "side") if name == "clap-ft" else ("mono",)
            r["min_cosine"] = min_cosine(
                dict(zip(heads, got)), dict(zip(heads, want)))
            if not r["min_cosine"] > 1.0 - CLAP_COS:
                raise AssertionError(f"{name}: the card's embeddings lie at "
                                     f"cosine {r['min_cosine']!r} of the "
                                     f"CPU's")
            if name == "gcn":
                # BatchNorm buffers after one train-mode forward on the
                # check batch, on each side from the same state
                card_bn, cpu_bn = copy.deepcopy(card_net), copy.deepcopy(
                    cpu_net)
                with torch.no_grad():
                    _, picks = shared_knn(lambda: card_bn.train()(batch))
                    (_, r["train_knn_flips"], r["train_knn_gap"],
                     _) = replay_knn(lambda: cpu_bn.train()(batch.cpu()),
                                     picks)
                errs = [float(((a.cpu().double() - b.double()).abs()
                               / b.double().abs().clamp_min(1.0)).max())
                        for (k, a), b in zip(card_bn.state_dict().items(),
                                             cpu_bn.state_dict().values())
                        if k.endswith(("running_mean", "running_var"))]
                r["bn_max_rel_err"] = max(errs)
                if not r["bn_max_rel_err"] <= BN_REL:
                    raise AssertionError(f"gcn: BatchNorm buffers "
                                         f"{r['bn_max_rel_err']!r} from the "
                                         f"CPU's")
                del card_bn, cpu_bn
            del cpu_net
            card_net.train().requires_grad_(True)
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            r["train_forward_ms"] = cuda_ms(lambda: card_net(x_train), 2)
            r["train_peak_bytes"] = torch.cuda.max_memory_allocated() - base
            r["weight_bytes"] = sum(
                t.numel() * t.element_size()
                for t in card_net.state_dict().values())
            log(f"backbone {name}: min cosine to the CPU "
                f"{r['min_cosine']!r}"
                + (f" (the card's k-NN picks served to the CPU; "
                   f"{r['knn_flips']} of the CPU's own picks differ, their "
                   f"largest relative gap {r['knn_gap']!r}, in train mode "
                   f"{r['train_knn_flips']}; BatchNorm buffers "
                   f"{r['bn_max_rel_err']!r} from the CPU's after a "
                   f"train-mode forward)" if name == "gcn" else "")
                + f"; train-mode forward at batch {BACKBONE_TRAIN_B} "
                f"{r['train_forward_ms']!r} ms, peak "
                f"{r['train_peak_bytes']} bytes; weights "
                f"{r['weight_bytes']} bytes")
            del card_net, got, want
        nets.clear()
        del x_train, x, batch
        torch.cuda.empty_cache()

        # (c) the CLI with --metric clap from the checkpoint's directory:
        # K6, K3 and K4 once per fitness call and no other kernel
        wav = os.path.join(tmp, "program.wav")
        save_audio(wav, program_audio(3, T_HEAD)[0], SR)
        os.chdir(tmp)
        try:
            res, launches, wall, calls, _ = cli_run(
                dev, tmp, wav, "clap", CLAP_CLI_POP, CLI_ITERS,
                ["--metric", "clap"])
        finally:
            os.chdir(cwd)
        if calls != CLI_ITERS + 1:
            raise AssertionError(f"clap cli: {calls} fitness calls")
        rec["cli"] = dict(evals_per_sec=res["evals_per_sec"],
                          time_elapsed=res["time_elapsed"], wall_s=wall,
                          launches=launches,
                          fval_history=list(res["fval_history"]))

        # (d) run_es with the tower's mid/side metric on the basic chain
        es = rec["es"] = {}
        rec["launches"] = phase_main(
            dev, model, es, "mega2", label="clap",
            embed_func=get_clap_laion_embeds_midside, popsize=CLAP_ES_POP)

        del model
        torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"clap phase: {rec['phase_s']!r} s")
    return rec["launches"]


class DrawLog:
    """Records the Cnn14's SpecAugment stripes, dropout masks and each
    time max's frame as a forward on the card takes them (``record``), and
    serves them again, in order, to a forward on the CPU (``replay``), so
    that both differentiate the same function. Replaying, it also counts
    the time maxes whose CPU frame differs from the card's and the
    largest relative gap between the two frames' values there."""

    def __init__(self):
        import st_ito_torch.models.cnn14 as cnn14

        self.mod = cnn14
        self.real = (cnn14.spec_augment_draws, cnn14.dropout_keep,
                     cnn14.time_pool)
        self.draws, self.frames = [], []
        self.flips, self.flip_gap = 0, 0.0

    def _set(self, spec, keep, pool):
        (self.mod.spec_augment_draws, self.mod.dropout_keep,
         self.mod.time_pool) = spec, keep, pool

    def record(self):
        real_spec, real_keep, real_pool = self.real

        def spec(*a):
            out = real_spec(*a)
            self.draws.append(out)
            return out

        def keep(*a):
            out = real_keep(*a)
            self.draws.append(out)
            return out

        def pool(h):
            self.frames.append(h.argmax(dim=2))
            return real_pool(h)

        self._set(spec, keep, pool)

    def replay(self, dev):
        draws, frames = list(self.draws), list(self.frames)

        def spec(g, n, frames_, bins, device):
            return [(s.to(dev), w.to(dev)) for s, w in draws.pop(0)]

        def keep(g, shape, device):
            m = draws.pop(0)
            assert tuple(m.shape) == tuple(shape), (m.shape, shape)
            return m.to(dev)

        def pool(h):
            idx = frames.pop(0).to(dev)
            own = h.argmax(dim=2)
            at = torch.gather(h, 2, idx[..., None])[..., 0]
            differ = own != idx
            if bool(differ.any()):
                top = torch.gather(h, 2, own[..., None])[..., 0]
                gap = ((top - at).abs() / top.abs().clamp_min(1e-30))[differ]
                self.flips += int(differ.sum())
                self.flip_gap = max(self.flip_gap, float(gap.max()))
            return at + h.mean(dim=2)

        self._set(spec, keep, pool)
        return draws, frames

    def restore(self):
        self._set(*self.real)


def pretext_first_step(cfg, batch, dev):
    """The first pretext step's (loss, {name: gradient}, BatchNorm buffers,
    s) of one weight set, run four ways, the card's draws and time-max
    frames replayed in the last three: on the card ("card"), on the card
    with cuDNN off ("card_native": torch's own float32 convolutions), on
    the CPU ("cpu") and on the CPU in float64 ("cpu64", the witness)."""
    import copy
    import dataclasses

    from st_ito_torch.models.cnn14 import no_tf32
    from st_ito_torch.train.param import (ParamEstimator,
                                          param_estimator_loss)

    base = ParamEstimator(cfg, torch.Generator().manual_seed(5))
    cpu = torch.device("cpu")
    draws = DrawLog()
    out = {}
    try:
        for label, where in (("card", dev), ("card_native", dev),
                             ("cpu", cpu), ("cpu64", cpu)):
            model = copy.deepcopy(base).to(where)
            b = {k: v.to(where) for k, v in batch.items()}
            if label == "cpu64":
                model = model.double()
                model.encoder.config = dataclasses.replace(
                    model.encoder.config, compute_dtype="float64")
                b = {k: v.double() if v.is_floating_point() else v
                     for k, v in b.items()}
            if label == "card":
                draws.record()
            else:
                left = draws.replay(where)
            gen = torch.Generator(device=where).manual_seed(0)
            t0 = time.perf_counter()
            with torch.backends.cudnn.flags(enabled=label != "card_native"):
                loss, _ = param_estimator_loss(model, cfg, b, True, gen)
                with no_tf32():
                    loss.backward()
            grads = {n: p.grad.double().cpu()
                     for n, p in model.named_parameters()
                     if p.grad is not None}
            bufs = {k: v.double().cpu() for k, v in
                    model.state_dict().items() if "running" in k}
            out[label] = (float(loss.detach()), grads, bufs,
                          time.perf_counter() - t0)
            if label != "card" and (left[0] or left[1]):
                raise AssertionError("card draws left unused")
            del model
    finally:
        draws.restore()
    out["flips"], out["flip_gap"] = draws.flips, draws.flip_gap
    return out


def grad_rel(got: dict, want: dict) -> float:
    """Relative L2 distance of two gradients over all parameters."""
    num = sum(float((got[k] - want[k]).norm()) ** 2 for k in want)
    den = sum(float(want[k].norm()) ** 2 for k in want)
    return math.sqrt(num / den)


def held_rows(recorded, dev):
    """Each instance's first TRAIN_CHECK_ROWS examples rendered again on
    their first T_HELD samples by the card and by the CPU:
    ({instance: max abs error}, {instance: error / limit}). The limit is
    1e-4 x peak (the scans' floored at 1), the chorus's DATAGEN_CHORUS
    x peak."""
    from st_ito_torch.chain import build_batched_render_fn

    errs, ratios = {}, {}
    for name, (chain, W, X) in sorted(recorded.items()):
        x = X[:TRAIN_CHECK_ROWS, :, :T_HELD].contiguous()
        w = W[:TRAIN_CHECK_ROWS]
        got = {}
        for label, where in (("card", dev), ("cpu", torch.device("cpu"))):
            render = build_batched_render_fn(
                chain, SR, 2, fast=True, peak_normalize_output=False,
                device=where)
            with torch.no_grad():
                got[label] = render(w.to(where), x.to(where)).cpu()
        want = got["cpu"]
        err = float((got["card"] - want).abs().max())
        peak = float(want.abs().max())
        rel = DATAGEN_CHORUS if name == "chorus" else 1e-4
        limit = rel * (max(1.0, peak) if name in SCAN_EFFECTS else peak)
        errs[name] = err
        ratios[name] = err / max(limit, 1e-30)
    return errs, ratios


def train_config(name, tmp, **changes):
    """``cfg/<name>`` read by the CLI's YAML reader, with ``changes``,
    written to ``tmp``: the path."""
    from st_ito_torch.cli import yaml_subset

    cfg = yaml_subset.load(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "cfg", name))
    cfg.update(changes)
    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        f.write(yaml_subset.dumps(cfg))
    return path, cfg


def phase_train(dev, rec):
    """Training at full width: datagen on the card's kernels, the pretext
    and style CLIs, the first pretext step against the CPU, the exported
    encoder in ``run_es``, ``run_learned_inference`` against the CPU."""
    import copy
    import tempfile
    import types

    import st_ito_torch.data.datagen as datagen
    from st_ito_torch.chain import basic_chain
    from st_ito_torch.cli import train as train_cli
    from st_ito_torch.data import (NpzShardDataset, generate_pretext_dataset,
                                   generate_style_dataset, sample_preset_bank)
    from st_ito_torch.ito import run_learned_inference
    from st_ito_torch.models import load_param_model
    from st_ito_torch.train import ParamEstimatorConfig
    from st_ito_torch.train.style import StyleTransferSystem

    t_phase = time.perf_counter()
    sources = [program_audio(10 + i, 2 * T_HEAD)[0].numpy()
               for i in range(TRAIN_SOURCES)]
    t0 = time.perf_counter()
    bank = sample_preset_bank(num_presets=TRAIN_PRESETS,
                              probe_len=TRAIN_PROBE, seed=0, device=dev)
    torch.cuda.synchronize()
    rec["preset_bank_s"] = time.perf_counter() - t0
    log(f"train: preset bank of {bank.num_instances} x {bank.num_presets} "
        f"in {rec['preset_bank_s']!r} s")

    recorded = {}
    real_build = datagen.build_batched_render_fn

    def watched(chain, *a, **k):
        render = real_build(chain, *a, **k)

        def run(W, X):
            name = chain.stages[0].effect
            if name not in recorded:
                recorded[name] = (chain, W.clone(), X.clone())
            return render(W, X)
        return run

    with tempfile.TemporaryDirectory() as tmp:
        shard_dir = os.path.join(tmp, "pretext")
        datagen.build_batched_render_fn = watched
        try:
            launch_counts(reset=True)
            t0 = time.perf_counter()
            paths = generate_pretext_dataset(
                sources, bank, shard_dir, TRAIN_EXAMPLES, length=T_HEAD,
                examples_per_shard=TRAIN_SHARD, seed=0, device=dev)
            torch.cuda.synchronize()
            rec["datagen_s"] = time.perf_counter() - t0
            gen_launches = launch_counts()
        finally:
            datagen.build_batched_render_fn = real_build
        inst = np.concatenate([np.load(p)["instance_index"] for p in paths])
        want = {k: 0 for k in gen_launches}
        for i, name in enumerate(bank.instance_names):
            subs = -(-int((inst == i).sum()) // TRAIN_SHARD)
            for k, n in DATAGEN_KERNELS[name].items():
                want[k] += subs * n
        if gen_launches != want:
            raise AssertionError(f"datagen launches {gen_launches}; "
                                 f"expected {want}")
        for k in ("k3", "k4", "k6", "k7", "k8", "k11"):
            if not gen_launches[k]:
                raise AssertionError(f"datagen launched no {k}")
        rec.update(datagen_launches=gen_launches, shards=len(paths),
                   instance_counts=np.bincount(
                       inst, minlength=bank.num_instances).tolist())
        log(f"train: datagen of {TRAIN_EXAMPLES} x {T_HEAD} in "
            f"{rec['datagen_s']!r} s, launches {gen_launches}")
        t0 = time.perf_counter()
        errs, ratios = held_rows(recorded, dev)
        rec.update(datagen_max_abs_err=errs, datagen_of_limit=ratios,
                   datagen_check_s=time.perf_counter() - t0)
        log(f"train: datagen renders, card against CPU on {T_HELD} samples "
            f"of {TRAIN_CHECK_ROWS} examples each, max abs "
            f"{json.dumps(errs)}; of the limit {json.dumps(ratios)}")
        # held at the phase's end, so that one run reads every gate
        failed = {f"datagen {k}": r for k, r in ratios.items()
                  if not r <= 1.0}

        # the pretext CLI at the canonical config, logging every step
        path, cfg = train_config("pretext-panns.yaml", tmp, log_every=1)
        run_dir = os.path.join(tmp, "run-pretext")
        args = ["--config", path, "--shard-dir", shard_dir, "--run-dir",
                run_dir]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = train_cli.main(args + ["--max-steps", str(PRETEXT_STEPS)])
        first_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        out2 = train_cli.main(args + ["--max-steps", str(PRETEXT_RESUME),
                                      "--resume"])
        if out2["state"].step != PRETEXT_RESUME:
            raise AssertionError(f"resumed to step {out2['state'].step}")
        metrics = [json.loads(line) for line in
                   open(os.path.join(run_dir, "metrics.jsonl"))]
        losses = [m["train_loss"] for m in metrics]
        if len(losses) != PRETEXT_RESUME or not np.isfinite(losses).all():
            raise AssertionError(f"pretext losses {losses}")
        # each run's first step (allocation, the loader's start) left out
        step_ms = [1e3 * s for s in out["step_s"][1:] + out2["step_s"][1:]]
        eps = [m["train_examples_per_sec"] for m in metrics]
        eps_steady = [e for m, e in zip(metrics, eps)
                      if m["step"] not in (1, PRETEXT_STEPS + 1)]
        rec["pretext"] = dict(
            ms_per_step=float(np.mean(step_ms)), ms_steps=step_ms,
            examples_per_sec=float(np.mean(eps_steady)),
            examples_per_sec_steps=eps,
            max_memory_allocated_bytes=peak, losses=losses,
            native_decode=out["use_native"], first_run_s=first_s,
            steps_after_resume=out2["state"].step)
        log(f"train: pretext {rec['pretext']['ms_per_step']!r} ms/step "
            f"after the first, {rec['pretext']['examples_per_sec']!r} "
            f"examples/s, peak {peak} bytes, decode "
            f"{'native' if out['use_native'] else 'numpy'}, losses "
            f"{losses}")
        del out, out2

        model = load_param_model(os.path.join(run_dir, "encoder.npz"),
                                 device=dev)
        es_rec = {}
        es_launches = phase_main(dev, model, es_rec, "mega2", label="train")
        rec["es"] = es_rec
        del model

        # the first step on the card and on the CPU
        enc = train_cli._encoder_config(cfg["model"]["encoder"])
        mcfg = {k: v for k, v in cfg["model"].items() if k != "encoder"}
        pcfg = ParamEstimatorConfig(encoder=enc, **mcfg)
        ds = NpzShardDataset(shard_dir, length=T_HEAD,
                             batch_size=TRAIN_CHECK_B, seed=1)
        batch = train_cli.to_device(next(iter(ds)), torch.device("cpu"))
        torch.cuda.empty_cache()
        steps = pretext_first_step(pcfg, batch, dev)
        l_c, l_h = steps["card"][0], steps["cpu"][0]
        loss_rel = abs(l_c - l_h) / abs(l_h)
        g = {k: v[1] for k, v in steps.items() if k in (
            "card", "card_native", "cpu", "cpu64")}
        rel = {"card_cpu": grad_rel(g["card"], g["cpu"]),
               "card_native_cpu": grad_rel(g["card_native"], g["cpu"]),
               "cpu_cpu64": grad_rel(g["cpu"], g["cpu64"]),
               "card_cpu64": grad_rel(g["card"], g["cpu64"]),
               "card_native_cpu64": grad_rel(g["card_native"], g["cpu64"])}
        b_c, b_h = steps["card"][2], steps["cpu"][2]
        bn_rel = max(float((b_c[k] - b_h[k]).norm()
                           / max(float(b_h[k].norm()), 1.0)) for k in b_h)
        # each tensor's distance from the witness, relative to the whole
        # gradient's norm: where the cards' and the CPU's roundings go
        norm64 = math.sqrt(sum(float(v.norm()) ** 2
                               for v in g["cpu64"].values()))
        per_tensor = {
            label: dict(sorted(
                ((k, float((g[label][k] - g["cpu64"][k]).norm()) / norm64)
                 for k in g["cpu64"]), key=lambda kv: -kv[1])[:4])
            for label in ("card", "card_native", "cpu")}
        rec["first_step"] = dict(
            loss_card=l_c, loss_cpu=l_h, loss_cpu64=steps["cpu64"][0],
            loss_rel=loss_rel, grad_rel_l2=rel, bn_rel=bn_rel,
            seconds={k: steps[k][3] for k in g},
            worst_tensors_from_cpu64=per_tensor,
            time_max_flips=steps["flips"],
            time_max_flip_gap=steps["flip_gap"])
        log(f"train: first pretext step: loss card {l_c!r}, CPU {l_h!r} "
            f"({loss_rel!r} relative), float64 {steps['cpu64'][0]!r}; "
            f"gradient relative L2 {json.dumps(rel)}; BatchNorm buffers "
            f"{bn_rel!r}; the CPU's own time-max frame differs in "
            f"{steps['flips']} of the card's, gap at most "
            f"{steps['flip_gap']!r}; the tensors farthest from float64 "
            f"{json.dumps(per_tensor)}")
        grad_ok = (rel["card_cpu"] <= TRAIN_GRAD_REL
                   or rel["card_cpu64"]
                   <= TRAIN_GRAD_WITNESS * rel["cpu_cpu64"])
        rec["first_step"]["grad_rule"] = (
            "a" if rel["card_cpu"] <= TRAIN_GRAD_REL else
            "b" if grad_ok else "missed")
        if not (loss_rel <= TRAIN_LOSS_REL and grad_ok and bn_rel <= BN_REL
                and steps["flip_gap"] <= KNN_TIE):
            failed["first_step"] = rec["first_step"]
        del steps, batch

        # the style CLI on the DeepAFx-ST+ analog
        style_dir = os.path.join(tmp, "style")
        generate_style_dataset(sources, basic_chain(with_bypass=False),
                               style_dir, STYLE_EXAMPLES, length=T_HEAD,
                               examples_per_shard=STYLE_EXAMPLES, seed=0,
                               device=dev)
        path, scfg = train_config("style-audio-otf.yaml", tmp, log_every=1)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        launch_counts(reset=True)
        out = train_cli.main(["--config", path, "--shard-dir", style_dir,
                              "--run-dir", os.path.join(tmp, "run-style"),
                              "--max-steps", str(STYLE_STEPS)])
        style_launches = launch_counts()
        if any(style_launches.values()):
            raise AssertionError(f"style training launched "
                                 f"{style_launches}")
        smetrics = [json.loads(line) for line in open(os.path.join(
            tmp, "run-style", "metrics.jsonl"))]
        slosses = [m["train_loss"] for m in smetrics]
        if not np.isfinite(slosses).all():
            raise AssertionError(f"style losses {slosses}")
        rec["style"] = dict(
            ms_per_step=float(np.mean([1e3 * s for s in out["step_s"][1:]])),
            ms_steps=[1e3 * s for s in out["step_s"]], losses=slosses,
            examples_per_sec=float(np.mean(
                [m["train_examples_per_sec"] for m in smetrics[1:]])),
            max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
        log(f"train: style {rec['style']['ms_per_step']!r} ms/step after "
            f"the first, peak {rec['style']['max_memory_allocated_bytes']} "
            f"bytes, losses {slosses}")

        system, state = out["system"], out["state"]
        x, y = program_audio(3, T_HEAD), program_audio(4, T_HEAD)
        run_learned_inference(x, y, SR, system, state)  # warm-up
        (res, learned_ms) = once_ms(
            lambda: run_learned_inference(x, y, SR, system, state))
        cpu_system = StyleTransferSystem(system.cfg, chain=system.chain,
                                         device="cpu")
        cpu_state = types.SimpleNamespace(
            model=copy.deepcopy(state.model).cpu())
        want = run_learned_inference(x, y, SR, cpu_system, cpu_state)
        err = max(abs(res["params"][k] - want["params"][k])
                  for k in want["params"])
        out_ok = bool(torch.isfinite(res["output_audio"]).all())
        rec["learned"] = dict(ms=learned_ms, params_max_abs_err=err,
                              output_finite=out_ok)
        log(f"train: run_learned_inference {learned_ms!r} ms, parameters "
            f"{err!r} from the CPU's")
        if not (err <= LEARNED_TOL and out_ok):
            failed["learned"] = rec["learned"]
        del out, system, state

    rec["launches"] = {k: gen_launches[k] + es_launches[k]
                       for k in gen_launches}
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"train: phase {rec['phase_s']!r} s, launches {rec['launches']}")
    if failed:
        raise AssertionError(f"train phase gates missed: {failed}")


# ------------------------------------------------------------------ mesh


def mesh_inputs(dev):
    """The headline's basic chain, input, styled target and a population
    of POP candidates (numpy seed 3)."""
    from st_ito_torch.chain import basic_chain

    chain = basic_chain()
    x = program_audio(0, T_HEAD)
    y = styled_target(x, chain, dev, 1)
    W = torch.from_numpy(np.random.default_rng(3).uniform(
        0.1, 0.9, (POP, chain.num_params)).astype(np.float32))
    return chain, x, y, W


def mesh_es_args(dev, **changes):
    """``run_es``'s arguments at the headline, one block of GENS
    generations in mega2."""
    return dict(dict(popsize=POP, find_w0=False, sigma0=0.33,
                     crop_len=T_HEAD, seed=0, verbose=False,
                     early_stop_patience=10**9, gens_per_dispatch=GENS,
                     fft_mode="mega2", max_iters=GENS, device=dev),
                **changes)


def mesh_pretext(dev):
    """The estimator's config at ``cfg/pretext-panns.yaml`` and MESH_STEPS
    global batches of its size (numpy seed 7) on ``dev``."""
    from st_ito_torch.cli import train as train_cli
    from st_ito_torch.cli import yaml_subset
    from st_ito_torch.train import ParamEstimatorConfig

    cfg = yaml_subset.load(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "cfg", "pretext-panns.yaml"))
    enc = train_cli._encoder_config(cfg["model"]["encoder"])
    mcfg = {k: v for k, v in cfg["model"].items() if k != "encoder"}
    pcfg = ParamEstimatorConfig(encoder=enc, **mcfg)
    bs, T = cfg["data"]["batch_size"], cfg["data"]["length"]
    rng = np.random.default_rng(7)

    def batch():
        audio = lambda: torch.from_numpy((rng.standard_normal(
            (bs, 2, T)) * 0.3).astype(np.float32)).to(dev)
        return {"inputs": audio(), "outputs": audio(),
                "instance_index": torch.from_numpy(rng.integers(
                    0, pcfg.num_instances, bs)).to(dev),
                "preset_index": torch.from_numpy(rng.integers(
                    0, pcfg.num_presets, bs)).to(dev),
                "tar_index": torch.zeros(bs, dtype=torch.long, device=dev)}

    return pcfg, [batch() for _ in range(MESH_STEPS)]


def state_digest(state) -> str:
    """sha256 of a trainer's state: the model's parameters and buffers and
    the optimisers' moments."""
    import hashlib

    tensors = list(state.model.state_dict().values())
    for opt in (state.opt, state.d_opt):
        if opt is not None:
            for st in opt.state.values():
                tensors += [v for v in st.values() if torch.is_tensor(v)]
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def pretext_step_witness(pcfg, batch, dev):
    """The first pretext step without a group on the card, from
    ``init_param_estimator``'s seed 0 and generator seed 0, in float32 and
    again in float64 (the witness) with the float32 run's draws and
    time-max frames replayed (``DrawLog``): (loss, {name: gradient}, ms)
    of each, and the float64 run's time maxes whose own frame differs."""
    import dataclasses

    from st_ito_torch.train import init_param_estimator, make_param_train_step

    draws = DrawLog()
    out = []
    try:
        for f64 in (False, True):
            state = init_param_estimator(pcfg, seed=0, device=dev)
            b = batch
            if f64:
                model = state.model.double()
                model.encoder.config = dataclasses.replace(
                    model.encoder.config, compute_dtype="float64")
                b = {k: v.double() if v.is_floating_point() else v
                     for k, v in batch.items()}
                left = draws.replay(dev)
            else:
                draws.record()
            gen = torch.Generator(device=dev).manual_seed(0)
            step = make_param_train_step(pcfg)
            (state, metrics), ms = once_ms(lambda: step(state, b, gen))
            if f64 and (left[0] or left[1]):
                raise AssertionError("float32 draws left unused")
            out.append((float(metrics["loss"]),
                        {n: p.grad.double().cpu() for n, p in
                         state.model.named_parameters()
                         if p.grad is not None}, ms))
            del state, metrics
            torch.cuda.empty_cache()
    finally:
        draws.restore()
    return out[0], out[1], draws.flips


def mesh_rank_job(rank, folder):
    """One of MESH_RANKS gloo ranks on the one card (NCCL refuses two
    ranks on one GPU): the float32 fitness of the headline population
    split over the ranks, then a block of ``run_es``, then the first
    pretext step on the same ranks as a "data" mesh (the global-batch
    BatchNorm, the gathered draws and the gradients averaged through host
    memory); its results saved to ``folder/rank{rank}.pt``."""
    import datetime

    import torch.distributed as dist

    from st_ito_torch.ito import make_fitness_fn, run_es
    from st_ito_torch.models import get_param_embeds, load_param_model
    from st_ito_torch.parallel import make_mesh
    from st_ito_torch.train import init_param_estimator, make_param_train_step

    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(folder, 'store')}",
        rank=rank, world_size=MESH_RANKS,
        timeout=datetime.timedelta(seconds=600))
    try:
        mesh = make_mesh(MESH_RANKS, "pop", device="cuda", backend="gloo")
        dev = mesh.device
        model = load_param_model(allow_random=True, seed=0, device=dev)
        chain, x, y, W = mesh_inputs(dev)
        fit = make_fitness_fn(chain, model, SR, 2, mesh=mesh,
                              compute_dtype="float32", fft_mode="mega2",
                              device=dev)
        tgt = get_param_embeds(y, model, SR)
        launch_counts(reset=True)
        fv, fit_ms = once_ms(lambda: fit(W, x[0], tgt))
        fit_launches = launch_counts()
        del fit
        torch.cuda.empty_cache()
        args = mesh_es_args(dev, mesh=mesh, fitness_dtype="float32")
        run_es(x, y, SR, chain, model, **args)  # warm-up
        torch.cuda.synchronize()
        launch_counts(reset=True)
        res = run_es(x, y, SR, chain, model, **args)
        out = {"fitness": fv.cpu(), "fitness_ms": fit_ms,
               "fitness_launches": fit_launches,
               "launches": launch_counts(),
               "fval_history": [float(v) for v in res["fval_history"]],
               "wopt": torch.from_numpy(np.asarray(res["wopt"])),
               "ms_per_generation": 1e3 * res["time_elapsed"] / GENS,
               "max_memory_allocated_bytes":
                   torch.cuda.max_memory_allocated(dev)}
        del model, x, y, W, tgt, res
        torch.backends.cuda.cufft_plan_cache.clear()
        torch.cuda.empty_cache()

        pcfg, batches = mesh_pretext(dev)
        state = init_param_estimator(pcfg, seed=0, device=dev)
        step = make_param_train_step(
            pcfg, make_mesh(MESH_RANKS, "data", device="cuda",
                            backend="gloo"))
        gen = torch.Generator(device=dev).manual_seed(0)
        (state, metrics), out["pretext_ms"] = once_ms(
            lambda: step(state, batches[0], gen))
        out["pretext_loss"] = float(metrics["loss"])
        out["pretext_digest"] = state_digest(state)
        if rank == 0:
            out["pretext_grads"] = {n: p.grad.cpu() for n, p in
                                    state.model.named_parameters()
                                    if p.grad is not None}
        torch.save(out, os.path.join(folder, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def mesh_pretext_steps(pcfg, batches, dev, mesh):
    """MESH_STEPS pretext steps from one seed, each run twice from the same
    state and generator state, without a group and on ``mesh``: per step
    (loss, gradients, ms) of each. The run goes on from the step without a
    group: a later step held against a state that cuDNN's float32 backward
    sums had already moved apart would measure them, not the mesh."""
    import copy

    from st_ito_torch.train import init_param_estimator, make_param_train_step

    state = init_param_estimator(pcfg, seed=0, device=dev)
    steps = {"ref": make_param_train_step(pcfg),
             "mesh": make_param_train_step(pcfg, mesh)}
    gen = torch.Generator(device=dev).manual_seed(0)
    out = []
    for batch in batches:
        start = gen.get_state()
        twin = copy.deepcopy(state)
        row = {}
        for label, st in (("ref", state), ("mesh", twin)):
            gen.set_state(start)
            (st, metrics), ms = once_ms(
                lambda: steps[label](st, batch, gen))
            row[label] = (float(metrics["loss"]),
                          {n: p.grad.double().cpu() for n, p in
                           st.model.named_parameters()
                           if p.grad is not None}, ms)
        out.append(row)
        del twin
    del state
    torch.cuda.empty_cache()
    return out


def phase_mesh(dev, model, rec):
    """The device mesh (ROADMAP §1 item 13). (a) An NCCL group of world
    size 1 on the card: ``run_es`` at the headline (popsize 512, stereo T
    262144, the basic chain in mega2, the deployed Cnn14) for one block of
    GENS generations, held bit for bit against the same run without a
    group, its launches counted (K1, K3, K4 once a generation); then
    MESH_STEPS pretext steps at ``cfg/pretext-panns.yaml`` on the "data"
    mesh, each against the same step without a group from the same state
    (``mesh_pretext_steps``), by the train phase's rules: the loss within
    TRAIN_LOSS_REL, the gradient within TRAIN_GRAD_REL (relative L2, rule
    (a); cuDNN's float32 backward sums differ from run to run, so not bit
    for bit). (b) MESH_RANKS gloo ranks on the one card,
    started here: the headline population split at MESH_POP_RANK a rank
    (the split population's K1, K3 and K4 at B 256 and the fitness
    all-gathered), the fitness in float32 within MESH_FIT_ABS of one
    process's on the same population, then a block of ``run_es``, its
    first generation's best within MESH_FIT_ABS of one process's; then the
    first pretext step on the same ranks as a "data" mesh (16 rows a rank,
    the global-batch BatchNorm, the gradients all-reduced over gloo through
    host memory), held against the same step in one process by the train
    phase's rules: the loss within TRAIN_LOSS_REL, the gradient by rule (a)
    (within TRAIN_GRAD_REL) or rule (b) (no farther from the float64
    witness, ``pretext_step_witness``, than TRAIN_GRAD_WITNESS times the
    one process's float32 gradient); both ranks return the same results
    and end in the same state."""
    import tempfile

    from st_ito_torch.ito import make_fitness_fn, run_es
    from st_ito_torch.models import get_param_embeds
    from st_ito_torch.parallel import make_mesh

    chain, x, y, W = mesh_inputs(dev)
    # (a) run_es, world size 1 over NCCL, against no group (after a
    # warm-up run)
    run_es(x, y, SR, chain, model, **mesh_es_args(dev))
    ref = run_es(x, y, SR, chain, model, **mesh_es_args(dev))
    mesh = make_mesh(1, "pop", device="cuda")
    try:
        if mesh.backend != "nccl" or mesh.world_size != 1:
            raise AssertionError(f"mesh {mesh}")
        launch_counts(reset=True)
        got = run_es(x, y, SR, chain, model, **mesh_es_args(dev, mesh=mesh))
        launches = launch_counts()
        want = {name: GENS * MODE_KERNELS["mega2"].get(name, 0)
                for name in launches}
        if launches != want:
            raise AssertionError(f"mesh (a): launches {launches}; expected "
                                 f"{want}")
        for k in ("fval_history", "wopt", "wopt_history"):
            if not np.array_equal(np.asarray(got[k]), np.asarray(ref[k])):
                raise AssertionError(f"mesh (a): run_es {k} differs from "
                                     f"the run without a group")
        rec.update(launches=launches,
                   es_ms_per_generation=1e3 * got["time_elapsed"] / GENS,
                   es_ref_ms_per_generation=1e3 * ref["time_elapsed"] / GENS,
                   fval_history=list(got["fval_history"]))
        log(f"mesh (a): run_es over an NCCL group of 1 bit for bit the "
            f"run without one: {rec['es_ms_per_generation']!r} ms/generation"
            f" ({rec['es_ref_ms_per_generation']!r} without), launches "
            f"{launches}")

        # (a) pretext steps on the "data" mesh (the same group)
        pcfg, batches = mesh_pretext(dev)
        steps = mesh_pretext_steps(pcfg, batches, dev,
                                   make_mesh(1, "data", device="cuda"))
        del batches
        rec["pretext"] = []
        for i, row in enumerate(steps):
            (l, g, ms), (l0, g0, ms0) = row["mesh"], row["ref"]
            loss_rel = abs(l - l0) / abs(l0)
            rel = grad_rel(g, g0)
            rec["pretext"].append({"loss": l, "loss_rel": loss_rel,
                                   "grad_rel": rel, "ms": ms,
                                   "ref_ms": ms0})
            log(f"mesh (a): pretext step {i + 1}: loss {l!r} ({loss_rel!r} "
                f"relative from no group), gradient {rel!r} relative L2, "
                f"{ms!r} ms ({ms0!r} without)")
            if not (math.isfinite(l) and loss_rel <= TRAIN_LOSS_REL
                    and rel <= TRAIN_GRAD_REL):
                raise AssertionError(f"mesh (a): pretext step {i + 1} off "
                                     f"the run without a group")
        del steps
    finally:
        mesh.close()

    # (b) MESH_RANKS gloo ranks on the card, then one process on the same
    # work, float32; the ranks run first, with this process's cached
    # memory (allocator blocks, cuFFT plans) given back to the card
    torch.backends.cuda.cufft_plan_cache.clear()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    log(f"mesh (b): {free / 2**30!r} GiB of {total / 2**30!r} free before "
        f"the ranks start")
    with tempfile.TemporaryDirectory() as tmp:
        jobs = [spawn(mesh_rank_job, r, tmp) for r in range(MESH_RANKS)]
        try:
            t0 = time.perf_counter()
            while any(job.is_alive() for job in jobs):
                failed = [job.exitcode for job in jobs
                          if job.exitcode not in (None, 0)]
                if failed:
                    raise AssertionError(f"mesh (b): a rank exited "
                                         f"{failed[0]}")
                if time.perf_counter() - t0 > 600:
                    raise AssertionError("mesh (b): the ranks ran 600 s")
                time.sleep(0.5)
            if any(job.exitcode != 0 for job in jobs):
                raise AssertionError(f"mesh (b): the ranks exited "
                                     f"{[job.exitcode for job in jobs]}")
            outs = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                    for r in range(MESH_RANKS)]
        finally:
            for job in jobs:
                stop(job)
    tgt = get_param_embeds(y, model, SR)
    fit = make_fitness_fn(chain, model, SR, 2, compute_dtype="float32",
                          fft_mode="mega2", device=dev)
    fv_ref = fit(W, x[0], tgt).cpu()
    ref32 = run_es(x, y, SR, chain, model,
                   **mesh_es_args(dev, fitness_dtype="float32"))
    del fit, tgt
    torch.cuda.empty_cache()
    r0 = outs[0]
    for r in outs[1:]:
        if not (torch.equal(r["fitness"], r0["fitness"])
                and r["fval_history"] == r0["fval_history"]
                and torch.equal(r["wopt"], r0["wopt"])
                and r["pretext_loss"] == r0["pretext_loss"]
                and r["pretext_digest"] == r0["pretext_digest"]):
            raise AssertionError("mesh (b): the ranks' results or pretext "
                                 "states differ")
    per_rank = {name: GENS * MODE_KERNELS["mega2"].get(name, 0)
                for name in r0["launches"]}
    for r in outs:
        if r["launches"] != per_rank or r["fitness_launches"] != {
                k: v // GENS for k, v in per_rank.items()}:
            raise AssertionError(f"mesh (b): launches {r['launches']}, "
                                 f"{r['fitness_launches']}")
    fit_err = float((r0["fitness"] - fv_ref).abs().max())
    gen1_err = abs(r0["fval_history"][0] - ref32["fval_history"][0])
    rec.update(ranks=MESH_RANKS, pop_per_rank=MESH_POP_RANK,
               fitness_max_abs_err=fit_err, gen1_abs_err=gen1_err,
               rank_fitness_ms=r0["fitness_ms"],
               rank_ms_per_generation=r0["ms_per_generation"],
               ref32_ms_per_generation=1e3 * ref32["time_elapsed"] / GENS,
               rank_launches=r0["launches"],
               rank_max_memory_allocated_bytes=[
                   r["max_memory_allocated_bytes"] for r in outs],
               fval_history_ranks=r0["fval_history"],
               fval_history_one=list(ref32["fval_history"]))
    log(f"mesh (b): {MESH_RANKS} gloo ranks x {MESH_POP_RANK}: float32 "
        f"fitness {fit_err!r} max abs from one process (limit "
        f"{MESH_FIT_ABS}), first generation's best {gen1_err!r}; "
        f"{r0['ms_per_generation']!r} ms/generation "
        f"({rec['ref32_ms_per_generation']!r} in one process), fitness call "
        f"{r0['fitness_ms']!r} ms, launches a rank {r0['launches']}")
    if not (fit_err <= MESH_FIT_ABS and gen1_err <= MESH_FIT_ABS
            and np.isfinite(r0["fval_history"]).all()):
        raise AssertionError("mesh (b): the split population's fitness "
                             "is off one process's")
    pcfg, batches = mesh_pretext(dev)
    (l0, g0, ms0), (l64, g64, ms64), flips = pretext_step_witness(
        pcfg, batches[0], dev)
    del batches
    l, g = r0["pretext_loss"], {k: v.double()
                                for k, v in r0["pretext_grads"].items()}
    loss_rel = abs(l - l0) / abs(l0)
    rel = {"ranks_one": grad_rel(g, g0), "ranks_f64": grad_rel(g, g64),
           "one_f64": grad_rel(g0, g64)}
    rule = ("a" if rel["ranks_one"] <= TRAIN_GRAD_REL else
            "b" if rel["ranks_f64"] <= TRAIN_GRAD_WITNESS * rel["one_f64"]
            else "missed")
    rec["pretext_ranks"] = {"loss": l, "loss_one": l0, "loss_f64": l64,
                            "loss_rel": loss_rel, "grad_rel_l2": rel,
                            "grad_rule": rule, "f64_time_max_flips": flips,
                            "ms": r0["pretext_ms"], "one_ms": ms0,
                            "f64_ms": ms64, "states_equal": True}
    log(f"mesh (b): pretext step 1 on {MESH_RANKS} gloo ranks: loss {l!r} "
        f"({loss_rel!r} relative from one process's {l0!r}; float64 "
        f"{l64!r}), gradient relative L2 {json.dumps(rel)}, rule {rule}; "
        f"the float64 run's own time-max frame differs in {flips}; "
        f"{r0['pretext_ms']!r} ms ({ms0!r} in one process); the ranks' "
        f"states equal")
    if not (math.isfinite(l) and loss_rel <= TRAIN_LOSS_REL
            and rule != "missed" and set(g) == set(g0)):
        raise AssertionError("mesh (b): the pretext step on the ranks is "
                             "off one process's")
    return rec["launches"]


def write_record(path, record):
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(record, f, indent=1, default=str)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--record", help="write the full record here (JSON)")
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of " + ",".join(PHASES))
    args = parser.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    if not set(phases) <= set(PHASES):
        parser.error(f"--phases takes a subset of {PHASES}")
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from st_ito_torch.models import load_param_model
    from st_ito_torch.ops.kernels import _build

    dev = torch.device("cuda")
    record = {}
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}")
    record["card"] = card

    t_start = t0 = time.perf_counter()
    secs = _build.build()
    log(f"kernels built in {time.perf_counter() - t0!r} s: {secs}")
    for name, text in _build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    record["build_s"] = secs
    record["build_logs"] = dict(_build.BUILD_LOGS)

    recs = {name: {} for name in ("k1", "k9", "k5", "k2", "k3", "k4", "k6",
                                  "k7", "k8", "k10", "k11", "groups")}

    def run(label, fn, *a):
        """fn(*a) with the card's clocks and power logged around it."""
        clocks(f"{label} start", record)
        out = fn(*a)
        clocks(f"{label} end", record)
        return out

    if "k1" in phases:
        run("k1", phase_k1, dev, recs["k1"])
    if "k9" in phases:
        run("k9", phase_k9, dev, recs["k9"])
    if "fft" in phases:
        run("fft", phase_fft, dev, recs)
    if "scan" in phases:
        run("scan", phase_scan, dev, recs)

    model = main_rec = None
    launches = {}
    if {"main", "style", "comp", "fx", "long", "multitrack", "dtype",
            "autodiff", "nofast", "eval", "mesh"} & set(phases):
        model = load_param_model(allow_random=True, seed=0, device=dev)
    if "main" in phases:
        main_rec = {mode: {} for mode in MODE_KERNELS}
        for mode in MODE_KERNELS:
            counts = run(f"main {mode}", phase_main, dev, model,
                         main_rec[mode], mode)
            # a kernel's count comes from the run of a mode that launches
            # it, the default mode's first
            for name in MODE_KERNELS[mode]:
                launches.setdefault(name, counts[name])
        base = main_rec["mx"]["ms_per_generation"]
        for mode, r in main_rec.items():
            log(f"{mode}: {r['ms_per_generation']!r} ms/generation, "
                f"{r['ms_per_generation'] / base!r} of mx")
    style_rec, comp_rec, cli_rec, long_rec, mt_rec = {}, {}, {}, {}, {}
    fx_rec, mfcc_rec = {}, {}
    if "style" in phases:
        launches["k8"] = run("style", phase_style, dev, model,
                             style_rec)["k8"]
    if "comp" in phases:
        launches["k7"] = run("comp", phase_comp, dev, model, comp_rec)["k7"]
    if "fx" in phases:
        # K11's count comes from the fx chain's run, the one path that
        # launches it
        launches["k11"] = run("fx", phase_fx, dev, model, fx_rec,
                              recs)["k11"]
    if "cli" in phases:
        launches["k6"] = run("cli", phase_cli, dev, cli_rec)["k6"]
    if "mfcc" in phases:
        run("mfcc", phase_mfcc, dev, mfcc_rec)
    if "long" in phases:
        run("long", phase_long, dev, model, long_rec)
    if "multitrack" in phases:
        run("multitrack", phase_multitrack, dev, model, mt_rec)
    dtype_rec, ad_rec, nofast_rec, eval_rec, pst_rec = {}, {}, {}, {}, {}
    if "dtype" in phases:
        run("dtype", phase_dtype, dev, model, dtype_rec)
    if "autodiff" in phases:
        run("autodiff", phase_autodiff, dev, model, ad_rec)
    if "nofast" in phases:
        run("nofast", phase_nofast, dev, model, nofast_rec)
    if "eval" in phases:
        run("eval", phase_eval, dev, model, eval_rec)
    if "pst" in phases:
        run("pst", phase_pst, dev, pst_rec)
    clap_rec = {}
    if "clap" in phases:
        run("clap", phase_clap, dev, clap_rec)
    train_rec = {}
    if "train" in phases:
        run("train", phase_train, dev, train_rec)
    mesh_rec = {}
    if "mesh" in phases:
        run("mesh", phase_mesh, dev, model, mesh_rec)

    record.update(recs=recs, main=main_rec, style=style_rec, comp=comp_rec,
                  fx=fx_rec, cli=cli_rec, mfcc=mfcc_rec, long=long_rec,
                  multitrack=mt_rec, dtype=dtype_rec, autodiff=ad_rec,
                  nofast=nofast_rec, eval=eval_rec, pst=pst_rec,
                  clap=clap_rec, train=train_rec, mesh=mesh_rec)
    if set(phases) != set(PHASES):
        log(f"partial run (phases {sorted(phases)}): no result line")
        write_record(args.record, record)
        return 0

    kernels = []
    for name, key, source, replaces in (
            ("k1_eq_compressor_fused", "k1", "st_ito_torch/csrc/eqcomp.cu",
             "st_ito_tpu/ops/pallas/scan.py:279"),
            ("k9_packed_response_apply", "k9",
             "st_ito_torch/csrc/packed_response.cu",
             "st_ito_tpu/ops/pallas/packed_response.py:133"),
            ("k5_fwd_pack_fft", "k5", "st_ito_torch/csrc/mega_fft.cu",
             "st_ito_tpu/ops/pallas/mega_fft.py:395"),
            ("k2_packed_response_apply_padded", "k2",
             "st_ito_torch/csrc/packed_response.cu",
             "st_ito_tpu/ops/pallas/packed_response.py:267"),
            ("k3_fwd_pack_fft_response", "k3",
             "st_ito_torch/csrc/mega_fft.cu",
             "st_ito_tpu/ops/pallas/mega_fft.py:431"),
            ("k4_inv_unpack_fft", "k4", "st_ito_torch/csrc/mega_fft.cu",
             "st_ito_tpu/ops/pallas/mega_fft.py:489"),
            ("k6_biquad_cascade", "k6", "st_ito_torch/csrc/scan.cu",
             "st_ito_tpu/ops/pallas/scan.py:133"),
            ("k7_compressor_fused", "k7", "st_ito_torch/csrc/scan.cu",
             "st_ito_tpu/ops/pallas/scan.py:436"),
            ("k8_ballistics", "k8", "st_ito_torch/csrc/scan.cu",
             "st_ito_tpu/ops/pallas/scan.py:810"),
            ("k10_fft_fused", "k10", "st_ito_torch/csrc/fused_fft.cu",
             "st_ito_tpu/ops/pallas/fused_fft.py:167"),
            ("k11_linear_recurrence", "k11", "st_ito_torch/csrc/scan.cu",
             "st_ito_tpu/ops/pallas/scan.py:836")):
        rec = recs[key]
        t_bytes = rec["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = rec["operations"] / FP32_OPS_PER_S * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": rec.get("library_ms")})
        # extra keys: the plain version's shape where it is not the
        # headline's, a chunked scan's chunk length (K6's carry table
        # traffic; K11's stages, its design's traffic floor and its broken
        # carries' rule (b) excess on the long memory), K3's,
        # K2's and K9's relative error on the comb resonances, and K10's
        # two calls (the entry is their mean)
        for extra in ("plain_shape", "chunk", "carry_table_bytes",
                      "resonance_rel_err", "ms_fwd", "ms_inv",
                      "plain_ms_fwd", "plain_ms_inv", "library_ms_fwd",
                      "library_ms_inv", "fx_ms", "fx_plain_ms",
                      "fx_max_abs_err", "fx_bound_ms", "stages_ms",
                      "traffic_floor_ms", "long_broken_b",
                      "head_long_broken_b"):
            if extra in rec:
                kernels[-1][extra] = rec[extra]
        # the long path's K1 (at its chunk) and K9 (at n 2^22), and each
        # kernel's launches in the long and multitrack runs
        if key in ("k1", "k9"):
            for extra in ("ms", "plain_ms", "max_abs_err", "bound_ms",
                          "chunk"):
                if f"{key}_{extra}" in long_rec:
                    kernels[-1][f"long_{extra}"] = long_rec[f"{key}_{extra}"]
        for label, r in (("long", long_rec), ("multitrack", mt_rec),
                         ("fx", fx_rec), ("mfcc", mfcc_rec),
                         ("nofast", nofast_rec), ("pst", pst_rec),
                         ("clap", clap_rec), ("train", train_rec),
                         ("mesh", mesh_rec)):
            kernels[-1][f"launches_{label}"] = r["launches"][key]
    record["kernels"] = kernels
    record["script_s"] = time.perf_counter() - t_start
    write_record(args.record, record)
    log(f"checks and runs took {record['script_s']!r} s after start-up")

    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
