"""Inter-core transport of the PyTorch port: mesh, multicast, router."""
