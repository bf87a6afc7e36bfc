"""Models of the PyTorch port: the paper's multi-core SNN (`snn`) and the
MLA + MoE language model (`config`, `blocks`, `lm`)."""
