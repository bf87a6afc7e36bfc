"""HAT-style hierarchical event routing, applied to MoE token dispatch.

Port of `repro.core.event_router`: a token's top-k expert choices are
address events, served in (token, slot) order (the arbiter's tie-break);
each expert is a core with a fixed-capacity input buffer, and events
beyond capacity are dropped, as an AER FIFO overflows.

What decides the drops is each event's arrival-order position within its
expert.  The JAX package finds it with a stable argsort of the event
stream, a segment scan and a scatter back.  The port takes it from the
`moe_dispatch` op under ``impl="pallas"`` - kernel B5 on CUDA tensors,
its plain version on CPU tensors - which computes exactly that position
without a sort, and writes each kept event into its ``(expert, slot)``
buffer entry directly.  Every field of `RouteResult` is the JAX one,
integer for integer.

The top-k is a stable descending sort: ``jax.lax.top_k`` puts the lower
expert index first among equal gates, and so does a stable sort, while
``torch.topk`` does not promise an order.  With bfloat16 router logits
ties are common, and their order is the arrival order of the events.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_dispatch import ops as moe_ops


class RouteResult(NamedTuple):
    expert_ids: torch.Tensor     # (T, k) int32 chosen experts
    weights: torch.Tensor        # (T, k) float combine weights (normalized)
    buffer_rows: torch.Tensor    # (E, C) int32 token row per slot, -1 = empty
    event_slot: torch.Tensor     # (T, k) int32 slot in expert buffer, -1 = dropped
    kept: torch.Tensor           # (T, k) bool event survived capacity
    load: torch.Tensor           # (E,) int32 tokens offered per expert (pre-drop)
    aux_loss: torch.Tensor       # scalar load-balance loss
    z_loss: torch.Tensor         # scalar router z-loss


def top_k_stable(gates: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: (values, int32 indices),
    largest first, the lower index first among equal values."""
    values, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k].to(torch.int32)


def hat_route(gate_logits: torch.Tensor, k: int, capacity: int,
              num_experts: int | None = None,
              use_hierarchical_scan: bool = False) -> RouteResult:
    """Route tokens to top-k experts with fixed per-expert capacity.

    gate_logits: (T, E) float.  Deterministic drop policy: events are
    served in (token, slot) order, so earlier tokens win buffer slots.
    ``use_hierarchical_scan`` picks between two scans in the JAX package
    that give the same positions; the port takes its positions from the
    `moe_dispatch` op either way.

    Raises:
      ValueError: when ``num_experts`` is smaller than the logits' width
        (an expert id would have no buffer).
    """
    del use_hierarchical_scan
    t, e = gate_logits.shape
    num_experts = num_experts or e
    if num_experts < e:
        raise ValueError(f"num_experts={num_experts} is below the gate "
                         f"logits' width {e}")
    dev = gate_logits.device
    logits = gate_logits.float()
    gates = torch.softmax(logits, dim=-1)
    top_w, top_ids = top_k_stable(gates, k)
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)

    # --- events in arbitration order: (token major, slot minor) ---------
    flat_ids = top_ids.reshape(-1)                       # (T*k,)
    m = flat_ids.numel()
    row = moe_ops.DEFAULT_ROW
    padded = F.pad(flat_ids, (0, -m % row), value=num_experts)
    pos, load = moe_ops.dispatch_positions(padded, num_experts=num_experts,
                                           impl="pallas", row=row)
    pos = pos[:m]

    # --- capacity arbitration -------------------------------------------
    kept = pos < capacity
    event_slot = torch.where(kept, pos, -1)

    # --- expert input buffers: kept (expert, slot) pairs are unique, and
    # dropped events land in one spare entry past the end ------------------
    rows = torch.arange(m, dtype=torch.int32, device=dev) // k
    spare = num_experts * capacity
    target = torch.where(kept, flat_ids.long() * capacity + pos, spare)
    buf = torch.full((spare + 1,), -1, dtype=torch.int32, device=dev)
    buf.scatter_(0, target, rows)
    buf = buf[:spare].view(num_experts, capacity)

    # --- aux losses (Switch-style) ----------------------------------------
    frac_tokens = load.float() / max(t * k, 1)
    frac_prob = gates.mean(0)
    aux = num_experts * torch.sum(frac_tokens * frac_prob)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    return RouteResult(expert_ids=top_ids, weights=top_w, buffer_rows=buf,
                       event_slot=event_slot.reshape(t, k),
                       kept=kept.reshape(t, k), load=load,
                       aux_loss=aux, z_loss=z)


def dispatch(x: torch.Tensor, route: RouteResult) -> torch.Tensor:
    """Gather token vectors into expert buffers: (T, d) -> (E, C, d)."""
    safe = torch.clamp_min(route.buffer_rows, 0).long()
    mask = (route.buffer_rows >= 0)[..., None]
    return torch.where(mask, x[safe], 0.0)


def combine(expert_out: torch.Tensor, route: RouteResult,
            t: int) -> torch.Tensor:
    """Scatter expert outputs back to tokens with combine weights.

    expert_out: (E, C, d) -> (T, d)
    """
    del t
    slot = torch.clamp_min(route.event_slot, 0).long()   # (T, k)
    ev = expert_out[route.expert_ids.long(), slot]       # (T, k, d)
    w = route.weights * route.kept.to(route.weights.dtype)
    return torch.einsum("tkd,tk->td", ev, w.to(ev.dtype))
