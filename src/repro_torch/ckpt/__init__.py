"""`repro_torch.ckpt` - atomic, keep-k, async checkpoints in the JAX
package's on-disk format (port of `repro.ckpt`)."""

from repro_torch.ckpt.manager import (  # noqa: F401
    CheckpointManager,
    load_meta,
    restore,
    save,
)

__all__ = ["CheckpointManager", "load_meta", "restore", "save"]
