"""Embed one signal with the AFx-Rep encoder — the counterpart of the
repository's ``scripts/embed.py``:

    python -m st_ito_torch.cli.embed [--ckpt PATH] [--allow-random] \\
        [--device cuda]

``--ckpt`` takes an ``afx-rep.npz`` or a Lightning ``afx-rep.ckpt``
(converted, and cached as ``.npz`` beside it); without it the usual
search runs (``load_param_model``). The input is numpy's
``default_rng(0)`` normal noise, (1, 2, 262144); the script prints the
shape and first four values of the mid and side embeddings.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--allow-random", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    from st_ito_torch.models import get_param_embeds, load_param_model
    from st_ito_torch.utils import resolve_device

    dev = resolve_device(args.device)
    model = load_param_model(args.ckpt, allow_random=args.allow_random,
                             device=dev)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 2, 262144)).astype(np.float32)).to(dev)
    embeds = get_param_embeds(x, model, sample_rate=48000)
    for head, label in (("mid", "mid :"), ("side", "side:")):
        e = embeds[head]
        print(label, tuple(e.shape), e[0, :4].cpu().numpy())
    return embeds


if __name__ == "__main__":
    main()
