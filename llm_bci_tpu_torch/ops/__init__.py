"""Tensor ops of the port. Importing this package builds nothing: the CUDA
kernels are compiled at their first launch (``ops/_build.py``)."""
