"""LM training of the PyTorch port (`step`)."""
