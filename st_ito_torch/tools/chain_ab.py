"""Time the chains of ``chip_smoke.py``'s ``main``, ``style`` and ``comp``
phases from the checkout at PATH, with timed blocks of several generations
and no nvidia-smi call between them, so that two checkouts (this one and,
e.g., ``git archive`` of its parent unpacked under a directory that
``.gitignore`` lists) can be compared in turns in one run on one card:

    python3 st_ito_torch/tools/chain_ab.py PATH [--gens 6] [--profile]

Run it as a file, not with ``-m``: it imports ``chip_smoke`` and the
``st_ito_torch`` package from PATH. Prints one line, ``AB PATH`` and the
ms per generation of each basic-chain ``fft_mode``, of ``style`` and of
``comp``, after the ``style`` run's caching-allocator counters and the
host's seconds in ``ops/multiband.py split_bands``; with ``--profile``,
then a ``torch.profiler`` summary of one more ``style`` block: the device
time by kernel and the host's time by call. Needs a card.
"""

import argparse
import os
import sys
import time

ALLOCATOR_KEYS = ("num_alloc_retries", "num_device_alloc", "num_device_free",
                  "segment.all.allocated", "segment.all.freed")


def profile_style(cs, model, dev, root):
    """A torch.profiler summary of one timed block of the style chain."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from st_ito_torch.chain import chain_from_json
    from st_ito_torch.ito import run_es

    chain = chain_from_json(os.path.join(root, cs.STYLE_CHAIN))
    x = cs.program_audio(0, cs.T_HEAD)
    y = cs.styled_target(x, chain, dev, 1)
    common = dict(popsize=cs.POP, find_w0=False, sigma0=0.33,
                  crop_len=cs.T_HEAD, seed=0, verbose=False,
                  early_stop_patience=10**9, gens_per_dispatch=cs.GENS,
                  fft_mode="auto", device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_es(x, y, cs.SR, chain, model, max_iters=cs.GENS, **common)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = prof.key_averages()
    device = sum(e.self_device_time_total for e in ev) / 1e3
    print(f"profiled style block: wall {wall * 1e3:.1f} ms, device time "
          f"summed over events {device:.1f} ms", flush=True)
    print(ev.table(sort_by="self_device_time_total", row_limit=22,
                   max_name_column_width=60), flush=True)
    for e in sorted(ev, key=lambda e: -e.self_cpu_time_total)[:12]:
        print(f"host {e.key[:60]}: self {e.self_cpu_time_total / 1e3:.1f} "
              f"ms, count {e.count}", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("path", help="the checkout to time")
    parser.add_argument("--gens", type=int, default=6,
                        help="generations in each timed block")
    parser.add_argument("--profile", action="store_true",
                        help="profile one more style block")
    args = parser.parse_args()
    root = os.path.abspath(args.path)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from st_ito_torch.models import load_param_model
    from st_ito_torch.ops import multiband

    cs.GENS = args.gens
    host = {"split_bands_s": 0.0, "calls": 0}
    split_bands = multiband.split_bands

    def timed_split_bands(*a, **k):
        t0 = time.perf_counter()
        out = split_bands(*a, **k)
        host["split_bands_s"] += time.perf_counter() - t0
        host["calls"] += 1
        return out

    multiband.split_bands = timed_split_bands
    dev = torch.device("cuda")
    model = load_param_model(allow_random=True, seed=0, device=dev)
    ms = {}
    for mode in cs.MODE_KERNELS:
        rec = {}
        cs.phase_main(dev, model, rec, mode)
        ms[mode] = rec["ms_per_generation"]
    before = torch.cuda.memory_stats()
    rec = {}
    cs.phase_style(dev, model, rec)
    after = torch.cuda.memory_stats()
    ms["style"] = rec["ms_per_generation"]
    print("style: allocator", {k: after.get(k, 0) - before.get(k, 0)
                               for k in ALLOCATOR_KEYS},
          "reserved peak", after.get("reserved_bytes.all.peak"),
          "host in split_bands", host, flush=True)
    rec = {}
    cs.phase_comp(dev, model, rec)
    ms["comp"] = rec["ms_per_generation"]
    print("AB", args.path, " ".join(f"{k} {v!r}" for k, v in ms.items()),
          flush=True)
    if args.profile:
        profile_style(cs, model, dev, root)


if __name__ == "__main__":
    main()
