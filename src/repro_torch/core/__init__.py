"""Core models of the PyTorch port: PPA constants, CAM PPA, arbiters."""
