"""Arbitration architectures for the neuromorphic core output interface.

Port of the vectorized half of `repro.core.arbiter`: the five schemes of
the paper (Tables I-III) as closed-form per-tick policies.

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

The discrete-event simulator (`_simulate`, the `Arbiter` drivers) is not
ported yet (ROADMAP queue A item 8).  Where the JAX package falls back to
it - a factory returning ``None``: ``greedy_tree`` at n <= 2,
``hier_ring`` at a non-square n - the port raises instead.

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

SCHEMES = ppa.SCHEMES

_SIMULATOR_ITEM = ("the discrete-event arbiter simulator is not ported yet "
                   "(ROADMAP queue A item 8)")


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
    """Registry entry: the vectorized policy bundle of one architecture.

    encode_energy(n, addr_seq (..., n)) -> (...) float32 toggles/event.
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


def tick_latency_fn(config: ArbiterConfig) -> Callable:
    """The scheme's dense per-tick latency policy for ``config``.

    Raises:
      NotImplementedError: where the closed form does not apply and the
        JAX package would run its discrete-event simulator instead.
    """
    entry: ArbiterScheme = interface_registry.get_arbiter(config.scheme)
    fn = (entry.tick_latency(make_context(config))
          if entry.tick_latency is not None else None)
    if fn is None:
        raise NotImplementedError(
            f"arbiter scheme {config.scheme!r} has no closed-form tick "
            f"latency at n={config.n}; {_SIMULATOR_ITEM}")
    return fn


def batched_tick_latency(config: ArbiterConfig, spikes: torch.Tensor
                         ) -> torch.Tensor:
    """Per-core encode completion time for frames of simultaneous spikes.

    spikes: (..., n) bool, every request at t=0.  Returns (...) float32.
    """
    return tick_latency_fn(config)(spikes)


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


for _entry in (
    ArbiterScheme("binary_tree", _flat_encode_energy,
                  tick_latency=_binary_tree_tick_latency,
                  sparse_tick_latency=_binary_tree_sparse_latency,
                  sparse_encode_energy=_flat_sparse_encode_energy,
                  kernel_policy=0),
    ArbiterScheme("greedy_tree", _flat_encode_energy,
                  tick_latency=_greedy_tree_tick_latency,
                  sparse_tick_latency=_greedy_tree_sparse_latency,
                  sparse_encode_energy=_flat_sparse_encode_energy,
                  kernel_policy=1),
    ArbiterScheme("token_ring", _flat_encode_energy,
                  tick_latency=_token_ring_tick_latency,
                  sparse_tick_latency=_token_ring_sparse_latency,
                  sparse_encode_energy=_flat_sparse_encode_energy,
                  kernel_policy=2),
    ArbiterScheme("hier_ring", _flat_encode_energy,
                  tick_latency=_hier_ring_tick_latency,
                  sparse_tick_latency=_hier_ring_sparse_latency,
                  sparse_encode_energy=_flat_sparse_encode_energy,
                  kernel_policy=3),
    ArbiterScheme("hier_tree", _hat_encode_energy,
                  tick_latency=_hier_tree_tick_latency,
                  sparse_tick_latency=_hier_tree_sparse_latency,
                  sparse_encode_energy=_hat_sparse_encode_energy,
                  kernel_policy=4),
):
    if _entry.name not in interface_registry.ARBITERS:
        interface_registry.register_arbiter(_entry.name, _entry)
del _entry
