"""Arbitration architectures for the neuromorphic core output interface.

Port of `repro.core.arbiter`: the five schemes of the paper (Tables
I-III) as closed-form per-tick policies, and the discrete-event simulator
those closed forms are held to.

  binary_tree  - flat binary arbiter tree (Boahen-style)
  greedy_tree  - binary tree with greedy re-grant of hot subtrees
  token_ring   - single token ring over all N neurons
  hier_ring    - two-level hierarchical token ring (HTR)
  hier_tree    - the paper's HAT: log4(N) levels of four-input arbiters

Each registered `ArbiterScheme` carries the dense ``tick_latency`` form
(a (..., n) spike frame), the event-compacted ``sparse_tick_latency`` and
``sparse_encode_energy`` forms (a (..., capacity + 1) ascending address
buffer padded with n, plus live counts), and ``encode_energy`` over a
dense address stream.  Every quantity is an exact small integer in
float32, so the results are the same bits as the JAX package's.

The discrete-event simulator (`_simulate`) serves one granted event a
step, n steps, through each scheme's policies (``select_key``,
``grant_delay``, ``token_update``), vectorised over any leading axes
(cores, lanes).  Where a scheme's closed form does not apply - a
factory returning ``None``: ``greedy_tree`` at n <= 2, ``hier_ring`` at
a non-square n - `tick_latency_fn` returns the simulator's tick
latency, as the JAX package's `batched_tick_latency` falls back to it.
`Arbiter` drives it as the JAX class does.

``kernel_policy`` names the compile-time branch of the CUDA kernels that
compute the scheme's policies: the sparse tick's
(`repro_torch/csrc/sparse_tick.cu`) and the whole-run arbiter terms'
(`repro_torch/csrc/hat_encode.cu`, `hat_run`).  A scheme registered
without one runs on the plain torch path only: on the card,
``impl="pallas_sparse"``, and ``impl="pallas"`` at an n that `hat_run`
takes, raise `ValueError` when the plan is bound.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from repro_torch.core import ppa
from repro_torch.interface import registry as interface_registry
from repro_torch.interface.types import resolve_device

SCHEMES = ppa.SCHEMES

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class ArbiterContext:
    """Static per-instance quantities shared by every policy callable."""

    n: int
    lg: float               # log2(n)
    sqrt_n: int
    levels: int             # HAT hierarchy levels
    fill: int               # HAT pipeline fill latency (units)


@dataclasses.dataclass(frozen=True)
class ArbiterScheme:
    """Registry entry: the policy bundle of one architecture.

    encode_energy(n, addr_seq (..., n)) -> (...) float32 toggles/event.
    select_key(ctx, tok_hi, tok_lo) -> (..., n) float32 priority among
        arrived requests (argmin wins); ``tok_*`` are (...) int64.
    grant_delay(ctx, sel, backlog, tok_hi, tok_lo, prev_addr, granted_any)
        -> (...) float32 delay between service start and grant.
    token_update(ctx, sel, taken, tok_hi, tok_lo) -> (tok_hi, tok_lo),
        optional ring-token advance after a grant.
    tick_latency(ctx) -> Optional[(..., n) bool -> (...) float32]
    sparse_tick_latency(ctx) -> Optional[(buf, counts) -> (...) float32]
    sparse_encode_energy(ctx) -> Optional[(buf, counts) -> (...) float32]
    kernel_policy: index of the scheme's branch in the CUDA sparse tick
        and hat_run kernels (`repro_torch.kernels.sparse_tick.kernel.
        POLICY_IDS`).
    """

    name: str
    encode_energy: Callable
    tick_latency: Optional[Callable] = None
    sparse_tick_latency: Optional[Callable] = None
    sparse_encode_energy: Optional[Callable] = None
    kernel_policy: Optional[int] = None
    select_key: Optional[Callable] = None
    grant_delay: Optional[Callable] = None
    token_update: Optional[Callable] = None


@dataclasses.dataclass(frozen=True)
class ArbiterConfig:
    """Static description of one arbitration architecture instance."""

    scheme: str
    n: int                      # neurons per core (power of two)
    branching: int = 4          # HAT: four-input arbiter per hierarchy level
    pipeline_fill: int = 3      # HAT: static-HC pipeline fill latency (units)

    def __post_init__(self):
        if self.scheme not in interface_registry.ARBITERS:
            raise ValueError(
                f"unknown scheme {self.scheme!r}; registered arbiters: "
                f"{', '.join(interface_registry.ARBITERS.names())}")
        if self.n & (self.n - 1):
            raise ValueError("n must be a power of two")

    @property
    def levels(self) -> int:
        """HAT hierarchy levels (2 address bits per level)."""
        return max(1, round(math.log(self.n, self.branching)))

    @property
    def addr_bits(self) -> int:
        return int(math.log2(self.n))


def make_context(config: ArbiterConfig) -> ArbiterContext:
    """The static `ArbiterContext` every policy callable receives."""
    n = config.n
    return ArbiterContext(n=n, lg=float(math.log2(n)),
                          sqrt_n=int(round(math.sqrt(n))),
                          levels=config.levels, fill=config.pipeline_fill)


def _ring_dist(frm, to, n):
    return torch.remainder(to - frm, n)


_DONE_EVERY = 16


def _simulate(request_times: torch.Tensor, entry: ArbiterScheme,
              ctx: ArbiterContext) -> torch.Tensor:
    """Serve every finite request; grant times (inf where no request).

    request_times: (..., n) float32.  One step grants one event: the
    scheme's key picks among requests that have arrived by the server's
    clock, or the earliest arrival (address tie-break) when none has.
    At most n steps, each a handful of whole-tensor ops over the leading
    axes.  The steps the JAX ``lax.scan`` runs past the last request
    re-select a served event and grant nothing, so the loop stops once
    every request is served (looked at every `_DONE_EVERY` steps: one
    host read of the card's state each time).
    """
    n = ctx.n
    req = request_times.to(torch.float32)
    lead, dev = req.shape[:-1], req.device
    addrs = torch.arange(n, device=dev)
    active = torch.isfinite(req)
    clock = torch.zeros(lead, dtype=torch.float32, device=dev)
    tok_hi = torch.zeros(lead, dtype=torch.int64, device=dev)
    tok_lo = torch.zeros(lead, dtype=torch.int64, device=dev)
    prev_addr = torch.zeros(lead, dtype=torch.int64, device=dev)
    served = torch.zeros(req.shape, dtype=torch.bool, device=dev)
    granted_any = torch.zeros(lead, dtype=torch.bool, device=dev)
    key_waiting = req * float(n) + addrs.to(torch.float32)
    grants = torch.full(req.shape, INF, dtype=torch.float32, device=dev)
    for step in range(n):
        pending = active & ~served
        if step % _DONE_EVERY == 0 and not bool(pending.any()):
            break
        arr = torch.where(pending, req, INF)
        arrived = pending & (arr <= clock[..., None])
        key = torch.where(arrived, entry.select_key(ctx, tok_hi, tok_lo), INF)
        waiting = torch.where(pending, key_waiting, INF)
        sel = torch.where(arrived.any(-1), key.argmin(-1), waiting.argmin(-1))
        sel_arr = req.gather(-1, sel[..., None])[..., 0]
        start = torch.maximum(sel_arr, clock)
        backlog = clock > sel_arr
        delay = entry.grant_delay(ctx, sel, backlog, tok_hi, tok_lo,
                                  prev_addr, granted_any).to(torch.float32)
        grant = start + delay
        taken = pending.gather(-1, sel[..., None])[..., 0]
        if entry.token_update is not None:
            tok_hi, tok_lo = entry.token_update(ctx, sel, taken, tok_hi,
                                                tok_lo)
        hit = (addrs == sel[..., None]) & taken[..., None]
        served = served | hit
        grants = torch.where(hit, grant[..., None], grants)
        clock = torch.where(taken, grant, clock)
        prev_addr = torch.where(taken, sel, prev_addr)
        granted_any = granted_any | taken
    return grants


def _simulated_tick_latency(config: ArbiterConfig) -> Callable:
    """The simulator's per-tick latency: every spike requests at t=0, and
    a core's latency is its last finite grant (0.0 without a spike)."""
    entry: ArbiterScheme = interface_registry.get_arbiter(config.scheme)
    ctx = make_context(config)

    def lat(spikes):
        req = torch.where(spikes, 0.0, INF).to(torch.float32)
        grants = _simulate(req, entry, ctx)
        last = torch.where(torch.isfinite(grants), grants, 0.0).amax(-1)
        return torch.where(spikes.any(-1), last, 0.0)
    return lat


def has_closed_form(config: ArbiterConfig) -> bool:
    """Does the scheme's vectorized tick latency apply at ``config``?"""
    entry: ArbiterScheme = interface_registry.get_arbiter(config.scheme)
    return (entry.tick_latency is not None
            and entry.tick_latency(make_context(config)) is not None)


def tick_latency_fn(config: ArbiterConfig) -> Callable:
    """The scheme's dense per-tick latency policy for ``config``: its
    closed form, or the discrete-event simulator where none applies (as
    the JAX package's `batched_tick_latency` falls back)."""
    entry: ArbiterScheme = interface_registry.get_arbiter(config.scheme)
    fn = (entry.tick_latency(make_context(config))
          if entry.tick_latency is not None else None)
    return fn if fn is not None else _simulated_tick_latency(config)


def batched_tick_latency(config: ArbiterConfig, spikes: torch.Tensor
                         ) -> torch.Tensor:
    """Per-core encode completion time for frames of simultaneous spikes.

    spikes: (..., n) bool, every request at t=0.  Returns (...) float32.
    """
    return tick_latency_fn(config)(spikes)


class Arbiter:
    """Discrete-event model of one core-output arbiter.

    ``device=None`` means the CUDA device (raising without one); pass
    ``device="cpu"`` for the CPU.  Requests are simulated there.
    """

    def __init__(self, config: ArbiterConfig, device=None):
        self.config = config
        self.device = resolve_device(device)

    def simulate(self, request_times) -> torch.Tensor:
        """request_times: (..., n) float, inf = no request -> grant times."""
        request_times = torch.as_tensor(request_times, dtype=torch.float32,
                                        device=self.device)
        if request_times.shape[-1:] != (self.config.n,):
            raise ValueError(f"expected shape ({self.config.n},)")
        entry = interface_registry.get_arbiter(self.config.scheme)
        return _simulate(request_times, entry, make_context(self.config))

    # ---- experiments (paper section III-D) ---------------------------------

    def sparse_event_latency(self, generator: torch.Generator,
                             num_trials: int = 64) -> torch.Tensor:
        """Average latency of isolated random single-neuron events (units);
        the positions are drawn from ``generator`` (on its device) and
        simulated on the arbiter's."""
        n = self.config.n
        positions = torch.randint(0, n, (num_trials,), generator=generator,
                                  device=generator.device).to(self.device)
        req = torch.full((num_trials, n), INF, dtype=torch.float32,
                         device=self.device)
        req[torch.arange(num_trials, device=self.device), positions] = 0.0
        grants = self.simulate(req)
        return grants.gather(-1, positions[:, None])[:, 0].mean()

    def burst_latency(self) -> torch.Tensor:
        """Completion time of a full-frame burst (all neurons fire at t=0)."""
        return self.simulate(torch.zeros((self.config.n,),
                                         device=self.device)).amax()

    # ---- closed forms ----------------------------------------------------

    def theoretical_sparse_units(self) -> float:
        return ppa.sparse_latency_units(self.config.scheme, self.config.n)

    def theoretical_burst_units(self) -> float:
        return ppa.burst_latency_units(self.config.scheme, self.config.n)

    def theoretical_area_units(self) -> float:
        return ppa.area_units(self.config.scheme, self.config.n)


# ---------------------------------------------------------------------------
# Encoding energy: flat trees drive log2(N) address lines per event; HAT
# re-encodes a level only when its cluster grant changes.
# ---------------------------------------------------------------------------


def encode_energy_units(scheme: str, n: int, addr_seq: torch.Tensor
                        ) -> torch.Tensor:
    """Average address-line toggles/event for granted address sequences."""
    entry: ArbiterScheme = interface_registry.get_arbiter(scheme)
    return entry.encode_energy(n, addr_seq)


def _flat_encode_energy(n: int, addr_seq: torch.Tensor) -> torch.Tensor:
    """Every event re-drives all log2(N) address lines."""
    return torch.full(addr_seq.shape[:-1], math.log2(n), dtype=torch.float32,
                      device=addr_seq.device)


def _prev(seq: torch.Tensor) -> torch.Tensor:
    """The sequence shifted right by one, with -1 before its first element."""
    return torch.cat([torch.full_like(seq[..., :1], -1), seq[..., :-1]], -1)


def _hat_encode_energy(n: int, addr_seq: torch.Tensor) -> torch.Tensor:
    """Level l re-encodes its 2 bits iff the prefix above level l changed.

    The toggle sum is an exact integer and n a power of two, so the mean
    is the same bits however the division is carried out.
    """
    levels = max(1, round(math.log(n, 4)))
    div = 4 ** torch.arange(levels, device=addr_seq.device)
    seq = addr_seq.long()
    changed = (torch.div(seq[..., None], div, rounding_mode="floor") !=
               torch.div(_prev(seq)[..., None], div, rounding_mode="floor"))
    toggles = torch.where(changed, 2.0, 0.0).sum((-2, -1))
    return toggles / float(addr_seq.shape[-1])


# ---------------------------------------------------------------------------
# Dense per-tick latency policies (`ArbiterScheme.tick_latency`): the
# closed form of the event loop's trajectory for a frame of simultaneous
# requests (first grant idle, the rest backlogged).
# ---------------------------------------------------------------------------


def _count(spikes: torch.Tensor) -> torch.Tensor:
    return spikes.sum(-1).to(torch.float32)


def _binary_tree_tick_latency(ctx):
    per_grant = 2.0 * (ctx.lg - 1.0)

    def lat(spikes):
        return _count(spikes) * per_grant
    return lat


def _greedy_tree_tick_latency(ctx):
    if ctx.lg <= 1.0:
        return None       # zero climb delay -> the event loop never backlogs
    first = 2.0 * (ctx.lg - 1.0)

    def lat(spikes):
        k = _count(spikes)
        return torch.where(k > 0.0, first + (k - 1.0) * 3.0, 0.0)
    return lat


def _token_ring_tick_latency(ctx):
    def lat(spikes):
        addrs = torch.arange(ctx.n, device=spikes.device)
        top = torch.where(spikes, addrs, -1).amax(-1)
        return torch.where(spikes.any(-1), top.to(torch.float32) + 1.0, 0.0)
    return lat


def _ring_total(lo_max: torch.Tensor, s: int) -> torch.Tensor:
    """Hierarchical ring drain time from per-section max lo (-1: empty)."""
    occupied = lo_max >= 0
    sec = torch.arange(s, device=lo_max.device)
    s_first = torch.where(occupied, sec, s).amin(-1)
    s_last = torch.where(occupied, sec, -1).amax(-1)
    total = (1 + s_first + 3 * (s_last - s_first) +
             torch.where(occupied, lo_max, 0).sum(-1))
    return total.to(torch.float32)


def _hier_ring_tick_latency(ctx):
    if ctx.sqrt_n * ctx.sqrt_n != ctx.n:
        return None           # top ring wraps inside the address space
    s = ctx.sqrt_n

    def lat(spikes):
        lo = torch.arange(s, device=spikes.device)
        sections = spikes.reshape(spikes.shape[:-1] + (s, s))
        lo_max = torch.where(sections, lo, -1).amax(-1)
        return torch.where(spikes.any(-1), _ring_total(lo_max, s), 0.0)
    return lat


def _hier_tree_tick_latency(ctx):
    # first grant fills the 2*levels pipeline; each later one costs 1 unit
    # plus 1 when the level-2 cluster switches (Q-1 switches)
    size = 4 ** (ctx.levels - 1)

    def lat(spikes):
        k = _count(spikes)
        occ = spikes.reshape(spikes.shape[:-1] + (-1, size)).any(-1)
        q = occ.sum(-1).to(torch.float32)
        return torch.where(k > 0.0,
                           2.0 * ctx.levels + (k - 1.0) + (q - 1.0), 0.0)
    return lat


# ---------------------------------------------------------------------------
# Sparse (event-compacted) policies: the same closed forms read from the
# compacted buffer.  Address prefixes use arithmetic right shifts, which
# floor-divide correctly for the -1 boundary sentinel.
# ---------------------------------------------------------------------------


def _binary_tree_sparse_latency(ctx):
    per_grant = 2.0 * (ctx.lg - 1.0)

    def lat(buf, counts):
        return counts.to(torch.float32) * per_grant
    return lat


def _greedy_tree_sparse_latency(ctx):
    if ctx.lg <= 1.0:
        return None
    first = 2.0 * (ctx.lg - 1.0)

    def lat(buf, counts):
        k = counts.to(torch.float32)
        return torch.where(k > 0.0, first + (k - 1.0) * 3.0, 0.0)
    return lat


def _token_ring_sparse_latency(ctx):
    def lat(buf, counts):
        top = torch.where(buf < ctx.n, buf, -1).amax(-1)
        return torch.where(counts > 0, top.to(torch.float32) + 1.0, 0.0)
    return lat


def _hier_ring_sparse_latency(ctx):
    if ctx.sqrt_n * ctx.sqrt_n != ctx.n:
        return None
    s = ctx.sqrt_n
    shift = int(math.log2(s))

    def lat(buf, counts):
        real = buf < ctx.n
        hi = torch.where(real, buf >> shift, s - 1).long()  # pads in range
        lo = torch.where(real, buf & (s - 1), -1)
        lo_max = torch.full(buf.shape[:-1] + (s,), -1, dtype=buf.dtype,
                            device=buf.device)
        lo_max = lo_max.scatter_reduce(-1, hi, lo, reduce="amax")
        return torch.where(counts > 0, _ring_total(lo_max, s), 0.0)
    return lat


def _hier_tree_sparse_latency(ctx):
    shift = 2 * (ctx.levels - 1)

    def lat(buf, counts):
        real = buf < ctx.n
        cluster = buf >> shift
        q = (real & (cluster != _prev(cluster))).sum(-1).to(torch.float32)
        k = counts.to(torch.float32)
        return torch.where(k > 0.0,
                           2.0 * ctx.levels + (k - 1.0) + (q - 1.0), 0.0)
    return lat


def _flat_sparse_encode_energy(ctx):
    const = math.log2(ctx.n)

    def enc(buf, counts):
        return torch.full(buf.shape[:-1], const, dtype=torch.float32,
                          device=buf.device)
    return enc


def _hat_sparse_encode_energy(ctx):
    # All toggles of the dense (n,)-padded stream happen inside the
    # compacted buffer (pairwise transitions, the -1 boundary and the first
    # pad boundary), so buffer toggles / n is the dense mean bit for bit.
    levels = ctx.levels

    def enc(buf, counts):
        shifts = 2 * torch.arange(levels, device=buf.device, dtype=buf.dtype)
        changed = (buf[..., None] >> shifts) != (_prev(buf)[..., None] >> shifts)
        toggles = torch.where(changed, 2.0, 0.0).sum((-2, -1))
        return toggles / float(ctx.n)
    return enc


# ---------------------------------------------------------------------------
# The simulator's policies (`ArbiterScheme.select_key`, ``grant_delay``,
# ``token_update``), over any leading axes: ``sel``, ``tok_*`` and
# ``prev_addr`` are (...) int64, ``backlog``/``granted_any``/``taken``
# (...) bool.
# ---------------------------------------------------------------------------


def _addrs(ctx, like):
    return torch.arange(ctx.n, device=like.device)


def _tree_select(ctx, tok_hi, tok_lo):
    """Trees grant the lowest pending address (deterministic tie-break)."""
    return _addrs(ctx, tok_hi).to(torch.float32).expand(
        tok_hi.shape + (ctx.n,))


def _token_ring_select(ctx, tok_hi, tok_lo):
    """Rings grant the nearest pending request downstream of the token."""
    return _ring_dist(tok_hi[..., None], _addrs(ctx, tok_hi), ctx.n).to(
        torch.float32)


def _hier_ring_select(ctx, tok_hi, tok_lo):
    s = ctx.sqrt_n
    a = _addrs(ctx, tok_hi)
    hi, lo = a // s, a % s
    th, tl = tok_hi[..., None], tok_lo[..., None]
    dist = _ring_dist(th, hi, s) * (s + 2) + _ring_dist(
        torch.where(hi == th, tl, 0), lo, s)
    return dist.to(torch.float32)


def _const(value, like):
    return torch.full(like.shape, value, dtype=torch.float32,
                      device=like.device)


def _binary_tree_delay(ctx, sel, backlog, tok_hi, tok_lo, prev_addr,
                       granted_any):
    return _const(2.0 * (ctx.lg - 1.0), sel)     # full round trip, always


def _greedy_tree_delay(ctx, sel, backlog, tok_hi, tok_lo, prev_addr,
                       granted_any):
    # greedy re-grant services backlog at leaf level (~3 units); a lone
    # event still pays the full climb
    return torch.where(backlog, 3.0, 2.0 * (ctx.lg - 1.0)).to(torch.float32)


def _token_ring_delay(ctx, sel, backlog, tok_hi, tok_lo, prev_addr,
                      granted_any):
    # idle: the token travels dist hops then grants (+1); backlogged: the
    # hop overlaps the previous handshake -> 1 unit/event
    dist = _ring_dist(tok_hi, sel, ctx.n).to(torch.float32)
    return torch.where(backlog, dist.clamp_min(1.0), dist + 1.0)


def _hier_ring_delay(ctx, sel, backlog, tok_hi, tok_lo, prev_addr,
                     granted_any):
    s = ctx.sqrt_n
    hi, lo = sel // s, sel % s
    d_hi = _ring_dist(tok_hi, hi, s).to(torch.float32)
    d_lo = _ring_dist(torch.where(hi == tok_hi, tok_lo, 0), lo, s).to(
        torch.float32)
    # idle: top hops + bottom hops + grant; backlogged: 1 unit/event with
    # a 3-unit section-switch penalty
    return torch.where(backlog, (d_lo + 3.0 * d_hi).clamp_min(1.0),
                       d_hi + d_lo + 1.0)


def _hier_tree_delay(ctx, sel, backlog, tok_hi, tok_lo, prev_addr,
                     granted_any):
    # sparse: 2 two-input stages per level; backlogged: 1 unit/event + 1
    # when the level-2 cluster switches, + the one-off pipeline fill
    size = 4 ** (ctx.levels - 1)
    switch = (sel // size != prev_addr // size).to(torch.float32)
    first = (~granted_any).to(torch.float32)
    return torch.where(backlog, 1.0 + switch + first * ctx.fill,
                       2.0 * ctx.levels).to(torch.float32)


def _token_ring_update(ctx, sel, taken, tok_hi, tok_lo):
    return torch.where(taken, sel, tok_hi), tok_lo


def _hier_ring_update(ctx, sel, taken, tok_hi, tok_lo):
    return (torch.where(taken, sel // ctx.sqrt_n, tok_hi),
            torch.where(taken, sel % ctx.sqrt_n, tok_lo))


for _entry in (
    ArbiterScheme("binary_tree", _flat_encode_energy,
                  tick_latency=_binary_tree_tick_latency,
                  sparse_tick_latency=_binary_tree_sparse_latency,
                  sparse_encode_energy=_flat_sparse_encode_energy,
                  kernel_policy=0,
                  select_key=_tree_select, grant_delay=_binary_tree_delay,
                  token_update=None),
    ArbiterScheme("greedy_tree", _flat_encode_energy,
                  tick_latency=_greedy_tree_tick_latency,
                  sparse_tick_latency=_greedy_tree_sparse_latency,
                  sparse_encode_energy=_flat_sparse_encode_energy,
                  kernel_policy=1,
                  select_key=_tree_select, grant_delay=_greedy_tree_delay,
                  token_update=None),
    ArbiterScheme("token_ring", _flat_encode_energy,
                  tick_latency=_token_ring_tick_latency,
                  sparse_tick_latency=_token_ring_sparse_latency,
                  sparse_encode_energy=_flat_sparse_encode_energy,
                  kernel_policy=2,
                  select_key=_token_ring_select, grant_delay=_token_ring_delay,
                  token_update=_token_ring_update),
    ArbiterScheme("hier_ring", _flat_encode_energy,
                  tick_latency=_hier_ring_tick_latency,
                  sparse_tick_latency=_hier_ring_sparse_latency,
                  sparse_encode_energy=_flat_sparse_encode_energy,
                  kernel_policy=3,
                  select_key=_hier_ring_select, grant_delay=_hier_ring_delay,
                  token_update=_hier_ring_update),
    ArbiterScheme("hier_tree", _hat_encode_energy,
                  tick_latency=_hier_tree_tick_latency,
                  sparse_tick_latency=_hier_tree_sparse_latency,
                  sparse_encode_energy=_hat_sparse_encode_energy,
                  kernel_policy=4,
                  select_key=_tree_select, grant_delay=_hier_tree_delay,
                  token_update=None),
):
    if _entry.name not in interface_registry.ARBITERS:
        interface_registry.register_arbiter(_entry.name, _entry)
del _entry
