"""Input data of the PyTorch port: rate-coded SNN rasters (`pipeline`)."""
