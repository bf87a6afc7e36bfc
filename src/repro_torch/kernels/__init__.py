"""Kernels of the PyTorch port: hand-written CUDA for Hopper beside the
plain torch version each one is held to (see each package's ``ref.py``)."""
