"""`repro_torch.optim` - AdamW as plain functions on trees of tensors
(port of `repro.optim`)."""

from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    AdamWState,
    global_norm,
    init,
    schedule,
    update,
)

__all__ = ["AdamWConfig", "AdamWState", "global_norm", "init", "schedule",
           "update"]
