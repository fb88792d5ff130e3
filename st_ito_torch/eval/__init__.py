"""Evaluation: the metric registry (``eval/metrics.py``)."""
