"""Metric monotonicity sweep — port of ``st_ito_tpu/eval/sweep.py``: sweep
one effect parameter and check that the metric's distance grows
monotonically with the parameter's distance."""

from __future__ import annotations

import numpy as np
import torch

from st_ito_torch.chain import EFFECT_REGISTRY, ChainSpec
from st_ito_torch.chain.executor import build_render_fn
from st_ito_torch.eval.metrics import style_similarity
from st_ito_torch.utils import resolve_device


def sweep_parameter(x, effect_name: str, param_name: str, model, embed_func,
                    sample_rate: int = 48000, num_steps: int = 11,
                    device="cuda") -> dict:
    """x: (2, T). Sweeps the parameter over [0, 1] on ``device`` (default
    the card), the similarity measured to the render at the sweep's
    minimum. Returns the values, the similarities and a Spearman
    monotonicity score."""
    dev = resolve_device(device)
    chain = ChainSpec(stages=(EFFECT_REGISTRY[effect_name](),),
                      with_bypass=False)
    render = build_render_fn(chain, sample_rate, 2, device=dev)
    pidx = chain.stages[0].param_names.index(param_name)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)

    w0 = np.asarray(chain.init_params())
    values = np.linspace(0.0, 1.0, num_steps)
    with torch.no_grad():
        outs = []
        for v in values:
            w = w0.copy()
            w[pidx] = v
            outs.append(render(torch.as_tensor(w, dtype=torch.float32), x))
        embeds = embed_func(torch.stack(outs), model, sample_rate)
        ref = {k: v[0:1] for k, v in embeds.items()}
        sims = style_similarity(embeds, ref).cpu().numpy()

    # monotonicity: rank correlation between parameter distance and 1 - sim
    d_param = values - values[0]
    d_metric = 1.0 - sims
    rho = _spearman(d_param[1:], d_metric[1:])
    return {
        "values": values.tolist(),
        "similarities": sims.tolist(),
        "monotonicity": float(rho),
    }


def _spearman(a: np.ndarray, b: np.ndarray) -> float:
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = np.sqrt((ra ** 2).sum() * (rb ** 2).sum())
    if denom < 1e-12:
        return 0.0
    return float((ra * rb).sum() / denom)
