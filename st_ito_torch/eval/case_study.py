"""Single-parameter recovery case study — port of
``st_ito_tpu/eval/case_study.py``: sweep one parameter to make a target at
a known value, then check whether the metric's similarity curve over the
sweep peaks at (or near) the true value, i.e. whether ITO can recover
it."""

from __future__ import annotations

import numpy as np
import torch

from st_ito_torch.chain import EFFECT_REGISTRY, ChainSpec
from st_ito_torch.chain.executor import build_render_fn
from st_ito_torch.eval.metrics import style_similarity
from st_ito_torch.utils import resolve_device


def parameter_recovery_curve(x, effect_name: str, param_name: str,
                             target_value: float, model, embed_func,
                             sample_rate: int = 48000, num_steps: int = 21,
                             device="cuda") -> dict:
    """x: (C, T). Returns the sweep values, the similarity-to-target curve,
    the value where it peaks and the recovery error |peak - target|;
    rendered and embedded on ``device`` (default the card)."""
    dev = resolve_device(device)
    chain = ChainSpec(stages=(EFFECT_REGISTRY[effect_name](),),
                      with_bypass=False)
    render = build_render_fn(chain, sample_rate, x.shape[0], device=dev)
    pidx = chain.stages[0].param_names.index(param_name)
    w0 = np.asarray(chain.init_params())
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)

    def at(v):
        w = w0.copy()
        w[pidx] = v
        return render(torch.as_tensor(w, dtype=torch.float32), x)

    values = np.linspace(0.0, 1.0, num_steps)
    with torch.no_grad():
        target_embeds = embed_func(at(target_value)[None], model,
                                   sample_rate)
        embeds = embed_func(torch.stack([at(v) for v in values]), model,
                            sample_rate)
        sims = style_similarity(embeds, target_embeds).cpu().numpy()

    best = float(values[int(np.argmax(sims))])
    return {
        "values": values.tolist(),
        "similarities": sims.tolist(),
        "target_value": float(target_value),
        "recovered_value": best,
        "recovery_error": abs(best - target_value),
    }
