"""Core models of the PyTorch port: PPA constants, CAM PPA, arbiters, and
the HAT event router applied to MoE dispatch (`event_router`)."""
