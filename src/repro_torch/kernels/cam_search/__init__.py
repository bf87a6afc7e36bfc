"""cam_search: packed-tag CAM associative search (CUDA kernel in
``repro_torch/csrc/cam_search.cu``, plain torch version in ``ref.py``)."""
