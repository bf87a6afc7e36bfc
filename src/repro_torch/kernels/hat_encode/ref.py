"""Plain torch oracle for hierarchical event encoding.

Port of `repro.kernels.hat_encode.ref`, over any leading batch axes, and
`hat_run_ref`, the plain version of the whole-run kernel: the
interface tick's composition of the scheme's dense latency with the
encode energy of the AER stream.
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


def arbiter_terms_ref(frames: torch.Tensor, latency_fn, encode_fn):
    """(latency, encode energy, events int32) of (..., n) bool frames: the
    scheme's dense latency, and the encode energy of each frame's AER
    stream."""
    ranks, count, _ = hat_encode_ref(frames, row=1)
    return (latency_fn(frames), encode_fn(compact_stream(ranks, count)),
            count)


def hat_run_ref(stream: torch.Tensor, latency_fn, encode_fn):
    """The arbiter's tick terms of every bitmap of a run.

    stream: (B, T, C, n) bool frames.  ``latency_fn`` maps (..., n) frames
    to (...) float32 latencies, ``encode_fn`` (..., n) int32 AER streams to
    (...) float32 encode energies.  Returns (latency, encode energy,
    events int32), each (T, B, C).
    """
    return arbiter_terms_ref(stream.transpose(0, 1), latency_fn, encode_fn)
