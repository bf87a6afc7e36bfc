"""lif_step: the fused leaky-integrate-and-fire update (CUDA kernel in
``repro_torch/csrc/lif_step.cu``, plain torch version in ``ref.py``)."""
