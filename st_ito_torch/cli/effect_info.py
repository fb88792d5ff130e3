"""Effect and chain introspection and a smoke test — port of
``st_ito_tpu/cli/effect_info.py``:

    python -m st_ito_torch.cli.effect_info                    # the registry
    python -m st_ito_torch.cli.effect_info parametric_eq      # parameters
    python -m st_ito_torch.cli.effect_info parametric_eq --test \\
        [--device cuda]                                       # a render

``--test`` renders 1 s of noise through the effect at random parameters on
``--device`` (default ``cuda``) and reports its statistics.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("effect", nargs="?", default=None)
    parser.add_argument("--test", action="store_true",
                        help="render random noise through the effect with "
                             "random parameters and report stats")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default) or cpu, for --test")
    args = parser.parse_args(argv)

    from st_ito_torch.chain import EFFECT_REGISTRY

    if args.effect is None:
        print("registered effects:")
        for name in sorted(EFFECT_REGISTRY):
            stage = EFFECT_REGISTRY[name]()
            kind = ("LTI (fusable)" if stage.response_fn is not None
                    else "nonlinear")
            print(f"  {name:16s} {len(stage.params):2d} params  "
                  f"{stage.num_channels}ch  {kind}")
        return None

    stage = EFFECT_REGISTRY[args.effect]()
    print(f"{stage.name} ({args.effect}), num_channels={stage.num_channels}")
    for p in stage.params:
        print(f"  {p.name:28s} [{p.min_value:10.2f}, {p.max_value:10.2f}] "
              f"default={p.default:8.2f} (raw {p.default_raw:.3f})")

    if not args.test:
        return None
    import numpy as np
    import torch

    from st_ito_torch.chain import ChainSpec
    from st_ito_torch.chain.executor import build_render_fn
    from st_ito_torch.utils import resolve_device

    dev = resolve_device(args.device)
    chain = ChainSpec(stages=(stage,), with_bypass=False)
    render = build_render_fn(chain, 48000, 2, peak_normalize_output=False,
                             device=dev)
    rng = np.random.default_rng(args.seed)
    x = rng.standard_normal((2, 48000)).astype(np.float32) * 0.3
    w = rng.random(chain.num_params).astype(np.float32)
    with torch.no_grad():
        y = render(torch.from_numpy(w), torch.from_numpy(x)).cpu().numpy()
    stats = {"finite": bool(np.isfinite(y).all()),
             "in_rms": float(np.sqrt(np.mean(x ** 2))),
             "in_peak": float(np.abs(x).max()),
             "out_rms": float(np.sqrt(np.mean(y ** 2))),
             "out_peak": float(np.abs(y).max())}
    print("\nsmoke test (random params, 1 s noise):")
    print(f"  finite: {stats['finite']}")
    print(f"  in  rms {stats['in_rms']:.4f} peak {stats['in_peak']:.4f}")
    print(f"  out rms {stats['out_rms']:.4f} peak {stats['out_peak']:.4f}")
    return stats


if __name__ == "__main__":
    main()
