"""Command-line entry points of the port: ``run_optim``, the style-transfer
CLI; ``eval_psm`` and ``eval_sweep``, the metric evaluations; and
``effect_info``, the effect registry's introspection."""
