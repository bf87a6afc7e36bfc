"""hat_encode: hierarchical AER address encoding (CUDA kernel in
``repro_torch/csrc/hat_encode.cu``, plain torch version in ``ref.py``)."""
