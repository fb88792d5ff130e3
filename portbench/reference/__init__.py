"""Plain references (PyTorch and NumPy) that decide ``correct``. Nothing
here imports the program under test, JAX, or the JAX package."""
