"""Plain torch versions of the CAM search.

Port of `repro.kernels.cam_search.ref`, plus `match_counts_ref`, the
match counted over the entries for a leading lane axis of valid flags,
which is what the interface tick's CAM match needs.
"""

from __future__ import annotations

import torch


def pack_bits(bits: torch.Tensor, word_bits: int = 32) -> torch.Tensor:
    """(..., nbits) {0,1} -> (..., ceil(nbits/word)) int32, little-endian
    words: the uint32 pattern of each word, read as int32."""
    nbits = bits.shape[-1]
    nwords = -(-nbits // word_bits)
    pad = nwords * word_bits - nbits
    b = torch.nn.functional.pad(bits.long(), (0, pad))
    b = b.reshape(bits.shape[:-1] + (nwords, word_bits))
    weights = 1 << torch.arange(word_bits, device=bits.device)
    words = (b * weights).sum(-1) & 0xFFFFFFFF
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(
        torch.int32)


def cam_search_ref(q_packed: torch.Tensor, t_packed: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """match[b, e] = valid[e] & all-words-equal.

    q_packed: (B, W) int32; t_packed: (E, W) int32; valid: (E,) bool/int
    returns (B, E) int32 in {0, 1}
    """
    eq = (q_packed[:, None, :] == t_packed[None, :, :]).all(-1)
    return (eq & valid.bool()[None, :]).to(torch.int32)


def first_match_ref(match: torch.Tensor) -> torch.Tensor:
    """(B, E) match matrix -> (B,) index of lowest matching entry (E if
    none), int32."""
    e = match.shape[-1]
    idx = torch.arange(e, dtype=torch.int32, device=match.device)
    return torch.where(match.bool(), idx, e).amin(-1).to(torch.int32)


def match_count_ref(match: torch.Tensor) -> torch.Tensor:
    """(B, E) match matrix -> (B,) int32 matches per query."""
    return match.sum(-1).to(torch.int32)


def match_counts_ref(q_packed: torch.Tensor, t_packed: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """counts[l, b] = sum_e valid[l, e] & all-words-equal(q[b], t[e]).

    q_packed: (B, W) int32; t_packed: (E, W) int32; valid: (L, E) bool/int
    returns (L, B) int32
    """
    eq = (q_packed[:, None, :] == t_packed[None, :, :]).all(-1)   # (B, E)
    return (eq[None] & valid.bool()[:, None, :]).sum(-1).to(torch.int32)
