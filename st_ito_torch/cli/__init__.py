"""Command-line entry points of the port: ``run_optim``, the style-transfer
CLI."""
