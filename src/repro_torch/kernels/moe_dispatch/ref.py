"""Plain torch oracle for the moe_dispatch kernel.

Port of `repro.kernels.moe_dispatch.ref`: the one-hot cumsum.  For ids
in ``[0, E)`` it is the JAX reference integer for integer.  For an id
outside that range the JAX reference's value is an artifact of its
gather's fill mode; this version gives the TPU kernel's contract there
(position 0, not counted in ``load``), the one the MoE router relies on
when it pads its stream with the id E.
"""

from __future__ import annotations

import torch


def dispatch_positions_ref(expert_ids: torch.Tensor, num_experts: int):
    """Arrival-order position of each event within its expert.

    expert_ids: (M,) int event stream in arbitration order.
    returns: pos (M,) int32   - #earlier events with the same expert
             load (E,) int32  - events per expert
    """
    ids = expert_ids.to(torch.int32)
    experts = torch.arange(num_experts, dtype=torch.int32, device=ids.device)
    onehot = (ids[:, None] == experts[None, :]).to(torch.int32)  # (M, E)
    csum = torch.cumsum(onehot, dim=0, dtype=torch.int32)
    valid = (ids >= 0) & (ids < num_experts)
    col = torch.where(valid, ids, 0).long()[:, None]
    pos = torch.where(valid, csum.gather(1, col)[:, 0] - 1, 0)
    return pos.to(torch.int32), onehot.sum(0, dtype=torch.int32)
