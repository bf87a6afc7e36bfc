"""Public ops for hierarchical address-event encoding.

Port of the XLA branch of `repro.kernels.hat_encode.ops`; the Pallas
branch (``impl="pallas"``) is ROADMAP queue A item 6 / queue B item 3.
"""

from __future__ import annotations

from repro_torch.kernels.hat_encode import ref


def hat_encode(spikes, *, row: int = 256):
    """Service ranks + counts for spike bitmaps (..., N)."""
    n = spikes.shape[-1]
    return ref.hat_encode_ref(spikes, row=row if n % row == 0 else 1)


def encode_stream(spikes, *, row: int = 256):
    """Compacted AER streams: active addresses in service order, padded N."""
    ranks, count, _ = hat_encode(spikes, row=row)
    return ref.compact_stream(ranks, count), count
