"""Plain torch oracle for hierarchical event encoding.

Port of `repro.kernels.hat_encode.ref`, over any leading batch axes.
"""

from __future__ import annotations

import torch


def hat_encode_ref(spikes: torch.Tensor, row: int = 256):
    """Hierarchical event encoding oracle.

    spikes: (..., N) bool/int {0,1}
    returns:
      ranks   (..., N) int32 - service order of each active neuron
              (ascending address), -1 for inactive
      count   (...) int32 - number of events
      cluster_counts (..., N // row) int32 - events per high-level cluster
    """
    s = spikes.to(torch.int32)
    n = s.shape[-1]
    incl = s.cumsum(-1)
    ranks = torch.where(s > 0, incl - 1, -1).to(torch.int32)
    count = incl[..., -1].to(torch.int32)
    cluster_counts = s.reshape(s.shape[:-1] + (n // row, row)).sum(-1).to(
        torch.int32)
    return ranks, count, cluster_counts


def compact_stream(ranks: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """ranks -> AER stream: addresses in service order, padded with N."""
    del count
    n = ranks.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=ranks.device)
    target = torch.where(ranks >= 0, ranks, n).long()  # inactive -> dropped
    out = torch.full(ranks.shape[:-1] + (n + 1,), n, dtype=torch.int32,
                     device=ranks.device)
    out.scatter_(-1, target, idx.expand_as(ranks).contiguous())
    return out[..., :n]
