"""Evaluation — port of ``st_ito_tpu/eval``: the metric registry
(``metrics``), known-target recovery (``synthetic``), metric monotonicity
sweeps (``sweep``), single-parameter recovery curves (``case_study``), the
production-style-metric quadruplet benchmark (``psm``) and its figures
(``plots``)."""

from st_ito_torch.eval.metrics import METRICS, load_metric, style_similarity

__all__ = ["METRICS", "load_metric", "style_similarity"]
