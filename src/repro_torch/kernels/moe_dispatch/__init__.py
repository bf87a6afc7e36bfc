"""moe_dispatch: arrival-order positions of routed events within their
expert (CUDA kernel in ``repro_torch/csrc/moe_dispatch.cu``, plain torch
version in ``ref.py``)."""
