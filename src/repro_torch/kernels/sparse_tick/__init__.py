"""sparse_tick: the fused rate-proportional event tick (CUDA kernel in
``repro_torch/csrc/sparse_tick.cu``, plain torch version in ``ref.py``)."""
