"""launch subsystem of the PyTorch port: meshes, rank spawning and the
shape and memory dry run."""
