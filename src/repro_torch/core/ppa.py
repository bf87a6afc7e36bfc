"""PPA (Power-Performance-Area) calibration constants for the core-interface models.

The paper (Su et al., 2023) reports closed-form *unit-domain* costs (latency in
two-input-arbiter delays, area in two-input-arbiter equivalents) next to measured
22FDX pre-layout numbers (ns / normalized area) at N = 64 and N = 256.  We treat
the closed forms as ground truth of the *algorithm* and fit a two-point affine
map ``measured = a * units + b`` per (scheme, mode) so the model reproduces the
paper's measured values exactly at the published design points and extrapolates
smoothly elsewhere (Fig. 5).

Everything here is a calibration input, not a claim: see DESIGN.md §2/§7.
Plain-Python copy of `repro.core.ppa` for the PyTorch port (which must not
import the JAX package); the TPU roofline constants are left out.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Tuple

# ---------------------------------------------------------------------------
# Closed-form unit-domain costs (paper Tables I-III).
# Latency unit = one two-input arbiter delay; area unit = one two-input arbiter.
# ---------------------------------------------------------------------------

SCHEMES = ("binary_tree", "greedy_tree", "token_ring", "hier_ring", "hier_tree")


def sparse_latency_units(scheme: str, n: int) -> float:
    """Average sparse-event latency in arbiter-delay units (Table I)."""
    lg = math.log2(n)
    return {
        "binary_tree": 2.0 * (lg - 1.0),
        "greedy_tree": 2.0 * (lg - 1.0),
        "token_ring": (n + 1) / 2.0,
        "hier_ring": math.sqrt(n),
        "hier_tree": lg,
    }[scheme]


def burst_latency_units(scheme: str, n: int) -> float:
    """Full-frame burst completion latency in arbiter-delay units (Table II)."""
    lg = math.log2(n)
    return {
        "binary_tree": 2.0 * n * (lg - 1.0),
        "greedy_tree": 3.0 * n - 6.0,
        "token_ring": float(n),
        "hier_ring": n + 2.0 * math.sqrt(n),
        "hier_tree": (17.0 / 16.0) * n + 3.0,
    }[scheme]


def area_units(scheme: str, n: int) -> float:
    """Number of two-input arbiters (Table III)."""
    return {
        "binary_tree": n - 1.0,
        "greedy_tree": n - 1.0,
        "token_ring": float(n),
        "hier_ring": n + 2.0 * math.sqrt(n),
        "hier_tree": 3.0 * math.log(n, 4),
    }[scheme]


# ---------------------------------------------------------------------------
# Measured 22FDX pre-layout values at (N=64, N=256) from the paper.
# latency entries are ns; area entries are normalized to one arbiter cell.
# ``None`` = not reported (greedy burst depends on neuron response time).
# ---------------------------------------------------------------------------

MEASURED_SPARSE_NS: Dict[str, Tuple[float, float]] = {
    "binary_tree": (1.7, 2.1),
    "greedy_tree": (1.8, 2.3),
    "token_ring": (25.3, 102.7),
    "hier_ring": (5.7, 9.2),
    "hier_tree": (1.7, 2.0),
}

MEASURED_BURST_NS: Dict[str, Tuple[float, float]] = {
    "binary_tree": (83.7, 436.9),
    "token_ring": (40.5, 178.4),
    "hier_ring": (48.9, 192.9),
    "hier_tree": (47.2, 194.4),
}

MEASURED_AREA_NORM: Dict[str, Tuple[float, float]] = {
    "binary_tree": (72.3, 277.4),
    "greedy_tree": (83.4, 286.7),
    "token_ring": (79.1, 272.5),
    "hier_ring": (89.2, 296.3),
    "hier_tree": (59.4, 192.4),
}

_DESIGN_POINTS = (64, 256)


@dataclasses.dataclass(frozen=True)
class AffineFit:
    """measured = a * units + b, fitted exactly through the two design points."""

    a: float
    b: float

    def __call__(self, units: float) -> float:
        return self.a * units + self.b


def _fit(units_fn: Callable[[str, int], float], scheme: str,
         measured: Dict[str, Tuple[float, float]]) -> AffineFit:
    u0, u1 = (units_fn(scheme, n) for n in _DESIGN_POINTS)
    m0, m1 = measured[scheme]
    if u1 == u0:  # degenerate; fall back to pure scaling
        return AffineFit(a=m0 / u0, b=0.0)
    a = (m1 - m0) / (u1 - u0)
    return AffineFit(a=a, b=m0 - a * u0)


def sparse_ns_fit(scheme: str) -> AffineFit:
    return _fit(sparse_latency_units, scheme, MEASURED_SPARSE_NS)


def burst_ns_fit(scheme: str) -> AffineFit:
    return _fit(burst_latency_units, scheme, MEASURED_BURST_NS)


def area_norm_fit(scheme: str) -> AffineFit:
    return _fit(area_units, scheme, MEASURED_AREA_NORM)


def sparse_latency_ns(scheme: str, n: int) -> float:
    return sparse_ns_fit(scheme)(sparse_latency_units(scheme, n))


def burst_latency_ns(scheme: str, n: int) -> float:
    if scheme == "greedy_tree":
        raise ValueError("paper does not report greedy-tree burst ns "
                         "(depends on neuron response time)")
    return burst_ns_fit(scheme)(burst_latency_units(scheme, n))


def area_normalized(scheme: str, n: int) -> float:
    return area_norm_fit(scheme)(area_units(scheme, n))


# ---------------------------------------------------------------------------
# CAM design points (paper §IV-D).  11-bit entries; arrays of 16 and 512.
# Areas in µm² (post-layout, summed cell areas).
# ---------------------------------------------------------------------------

CAM_BITS = 11
CAM_SPEC_SENSE_BITS = 3  # "last three CAM cells" extracted for speculative sense

CAM_AREA_UM2 = {
    # entries: (baseline, proposed)
    16: (225.3, 245.5),
    512: (7242.1, 7620.6),
}

# Paper-reported relative improvements the behavioural model must reproduce.
CAM_CYCLE_IMPROVEMENT = {16: 0.355, 512: 0.404}   # throughput-equivalent cycle-time cut
CAM_ENERGY_SAVING = {
    "all_match": 0.358,     # feedback control + CSCD
    "all_mismatch": 0.402,  # speculative sense (+CSCD)
    "random": 0.467,        # everything combined
}

# DYNAPs-referenced motivation (paper §I): arbiter + routing memory power share.
CORE_INTERFACE_POWER_SHARE = 0.80


def spec_sense_close_probability(n_bits: int, n_sense: int) -> float:
    """P(current source closed early | entry is MISMATCH), random data.

    Paper §IV-B: probability that at least one of the last ``n_sense`` bits
    mismatches, given the entry mismatches, with uniformly random data.  The
    paper's expression (2^N - 2^(N-n) + 1) / 2^N evaluates to 0.876 for
    N=10, n=3; conditioned on MISMATCH (2^N - 1 mismatching patterns) the
    exact form is (2^N - 2^(N-n)) / (2^N - 1).  We keep the paper's published
    expression so benchmark tables match the paper verbatim.
    """
    return (2.0 ** n_bits - 2.0 ** (n_bits - n_sense) + 1.0) / 2.0 ** n_bits


def spec_sense_close_probability_exact(n_bits: int, n_sense: int) -> float:
    """Exact conditional form (matches Monte-Carlo at every design point).

    The paper's expression above approximates this; they differ by O(2^-N)
    at the paper's N=10 design point but visibly at small N."""
    return (2.0 ** n_bits - 2.0 ** (n_bits - n_sense)) / (2.0 ** n_bits - 1.0)


# ---------------------------------------------------------------------------
# NoC (2D-mesh inter-core transport) behavioural constants.
#
# The paper assumes a routing fabric between cores but only optimizes the
# per-core interface; the mesh model follows the DYNAPs hierarchy (Moradi et
# al., arXiv:1708.04198): per-hop router traversal latency, per-event link
# serialization under contention, and per-traversal energy.  Latencies are ns
# in the same 22FDX-flavoured domain as the arbiter fits above; hop energy is
# expressed in the CAM model-unit domain (one full-window MISMATCH DC
# dissipation) so NoC and CAM energies can be summed into a system total: one
# hop (link drivers + router crossbar) is charged like ~35 CAM mismatch cells.
# Calibration inputs, not claims - see DESIGN.md §2.
# ---------------------------------------------------------------------------

NOC_HOP_LATENCY_NS = 1.2         # router traversal + link flight per hop
NOC_LINK_SERIALIZATION_NS = 0.8  # per event on the most contended link
NOC_HOP_ENERGY = 35.0            # model units per link traversal

# Inter-chip router tier (the DYNAPs R3 level, arXiv:1708.04198 §III):
# chip-to-chip hops leave the die, so they pay pad/SerDes flight time and
# off-chip driver energy - an order of magnitude over an on-chip mesh hop.
# Same unit domains as the on-chip constants so tiers can be summed.
CHIP_HOP_LATENCY_NS = 12.0        # SerDes + package flight per chip hop
CHIP_LINK_SERIALIZATION_NS = 4.0  # per event on the busiest chip link
CHIP_HOP_ENERGY = 350.0           # model units per chip-link traversal
