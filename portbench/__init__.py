"""The benchmark of the PyTorch and CUDA port (``st_ito_torch``): see
``run.py`` and PERF.md."""
