"""Models of the PyTorch port: the paper's multi-core SNN (`snn`)."""
