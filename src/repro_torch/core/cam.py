"""Asynchronous CAM routing-memory model (paper §IV).

Port of `repro.core.cam`, both layers:

- functional: `search` / `first_match` / `mismatch_bit_counts` and the
  stateful `CamArray`, the NOR-type CAM semantics of the core input
  interface, in plain torch (the session's tick uses the decoded
  `RoutingIndex` gather, or the `cam_search` kernel, instead);
- behavioural PPA: the registered circuit variants, `CamConfig`, the
  cycle-time, per-search energy and area models, and the paper's
  savings (`energy_saving`, `cycle_improvement`).

Calibration constants are copied verbatim so both packages compute the
same numbers from the same inputs.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import ppa
from repro_torch.interface import registry as interface_registry
from repro_torch.interface.types import resolve_device

# ---------------------------------------------------------------------------
# Functional CAM semantics
# ---------------------------------------------------------------------------


def search(tags, valid, query) -> torch.Tensor:
    """Parallel search: match[e] = valid[e] and tags[e, :] == query.

    tags:  (entries, bits) {0,1} int
    valid: (entries,) bool
    query: (bits,) or (batch, bits), on the tags' device
    returns (entries,) or (batch, entries) bool
    """
    tags = torch.as_tensor(tags)
    valid = torch.as_tensor(valid, device=tags.device)
    query = torch.as_tensor(query, device=tags.device)
    if query.ndim == 1:
        return (tags == query[None, :]).all(-1) & valid
    eq = (tags[None, :, :] == query[:, None, :]).all(-1)
    return eq & valid[None, :]


def first_match(tags, valid, query) -> torch.Tensor:
    """Index of the lowest matching entry, or `entries` if none."""
    m = search(tags, valid, query)
    entries = m.shape[-1]
    idx = torch.arange(entries, device=m.device)
    return torch.where(m, idx, entries).amin(-1)


def mismatch_bit_counts(tags, query) -> torch.Tensor:
    """Per-entry number of mismatching bits (drives the energy model)."""
    tags = torch.as_tensor(tags)
    query = torch.as_tensor(query, device=tags.device)
    q = query[None, :] if query.ndim == 1 else query[:, None, :]
    t = tags if query.ndim == 1 else tags[None, :, :]
    return (t != q).sum(-1)


# --- cycle-time calibration (ns): see repro.core.cam for the derivation ----
T_REQ = 0.2
T_RESET = 0.5
T_SENSE = 0.3
DELAY_MARGIN = 0.3          # "usually 30% higher than the dummy path" (§IV-D)
D0 = 1.425916
D1 = 0.173986
SETTLE_FRAC = {  # (feedback, speculative) -> fraction of dummy charge time
    (False, False): 1.00,
    (True, False): 0.70,
    (False, True): 0.85,
    (True, True): 0.58,
}

# --- energy calibration (units: one full-window MISMATCH DC dissipation) ----
P_SS = ppa.spec_sense_close_probability(ppa.CAM_BITS, ppa.CAM_SPEC_SENSE_BITS)
E_SENSE_NODE = 0.02
E_CSCD_NET = 25.0
M_CHARGE = 9.796
F_CONV = 518.58

# --- area calibration (um^2), exact through both published design points ----
A_ENTRY_BASE = 7016.8 / 496      # 14.1468  (11 CAM cells + MLSA)
A_PERIPH_BASE = 225.3 - 16 * A_ENTRY_BASE
A_ENTRY_PROP = 7375.1 / 496      # 14.8691  (+OR gate in MLSA; no cell growth)
A_PERIPH_PROP = 245.5 - 16 * A_ENTRY_PROP  # ~= 7.6 um^2: the CSCD block


@dataclasses.dataclass(frozen=True)
class CamVariant:
    """Registry entry: circuit-level knobs of one CAM design variant."""

    name: str
    cscd: bool
    feedback: bool
    speculative: bool
    settle_frac: float | None = None
    match_charge_factor: float = 1.0


@dataclasses.dataclass(frozen=True)
class CamConfig:
    entries: int
    bits: int = ppa.CAM_BITS
    sense_bits: int = ppa.CAM_SPEC_SENSE_BITS
    cscd: bool = True
    feedback: bool = True
    speculative: bool = True
    variant_name: str | None = None   # explicit registered variant override

    @property
    def variant(self) -> str:
        if self.variant_name is not None:
            return self.variant_name
        if not self.cscd:
            return "conventional"
        tags = ["cscd"]
        if self.feedback:
            tags.append("fb")
        if self.speculative:
            tags.append("ss")
        return "+".join(tags)

    def variant_entry(self) -> CamVariant:
        """The registered `CamVariant` this config resolves to."""
        return interface_registry.get_cam_variant(self.variant)


def dummy_charge_ns(entries: int) -> float:
    return D0 + D1 * math.log2(entries)


def cycle_time_ns(cfg: CamConfig) -> float:
    """Average search cycle time (four-phase handshake, §IV-D 'Cycle time')."""
    v = cfg.variant_entry()
    t_d = dummy_charge_ns(cfg.entries)
    if not v.cscd:
        return T_REQ + (1.0 + DELAY_MARGIN) * t_d + T_RESET
    return T_REQ + v.settle_frac * t_d + T_SENSE + T_RESET


def spec_close_probability(cfg: CamConfig) -> float:
    return ppa.spec_sense_close_probability(cfg.bits, cfg.sense_bits)


def energy_coefficients(cfg: CamConfig) -> tuple[float, float, float]:
    """(energy per match, per mismatch, fixed per search) as Python floats."""
    v = cfg.variant_entry()
    e_match = M_CHARGE * v.match_charge_factor
    if v.speculative:
        p = spec_close_probability(cfg)
        e_mm = (1.0 - p) + p * E_SENSE_NODE
    else:
        e_mm = 1.0
    return e_match, e_mm, F_CONV + (E_CSCD_NET if v.cscd else 0.0)


def search_energy(cfg: CamConfig, n_match: float, n_mismatch: float) -> float:
    """Average per-search energy for a given match composition (model units).

    Raises:
      ValueError: feedback or speculative sensing without CSCD, unless a
        registered variant is named explicitly.
    """
    if not cfg.cscd and (cfg.feedback or cfg.speculative) \
            and cfg.variant_name is None:
        raise ValueError("feedback/speculative require the CSCD architecture")
    e_match, e_mismatch, fixed = energy_coefficients(cfg)
    return n_match * e_match + n_mismatch * e_mismatch + fixed


def search_energy_for_queries(cfg: CamConfig, tags, valid, queries
                              ) -> torch.Tensor:
    """Average model energy over a batch of actual queries (0-d float32)."""
    m = search(tags, valid, queries)          # (batch, entries)
    n_match = m.sum(-1).to(torch.float32)
    n_valid = torch.as_tensor(valid, device=m.device).sum().to(
        torch.float32)
    return energy(cfg, n_match, n_valid - n_match).mean()


def energy(cfg: CamConfig, n_match, n_mismatch):
    """Per-search model energy for float32 match/mismatch tensors.

    The torch form of `repro.core.cam._energy_jnp`: the same Python-float
    coefficients applied to the per-search match composition.
    """
    e_match, e_mm, fixed = energy_coefficients(cfg)
    return n_match * e_match + n_mismatch * e_mm + fixed


def area_um2(cfg: CamConfig) -> float:
    if cfg.variant_entry().cscd:
        return A_ENTRY_PROP * cfg.entries + A_PERIPH_PROP
    return A_ENTRY_BASE * cfg.entries + A_PERIPH_BASE


def energy_saving(case: str, entries: int = 512) -> float:
    """Model-predicted saving of the full proposed design vs. baseline."""
    conv = CamConfig(entries, cscd=False, feedback=False, speculative=False)
    prop = CamConfig(entries)
    if case == "all_match":
        comp = (float(entries), 0.0)
    elif case == "all_mismatch":
        comp = (0.0, float(entries))
    elif case == "random":
        # uniformly random query & tags: per-entry match prob = 2^-bits
        p = 2.0 ** (-prop.bits)
        comp = (entries * p, entries * (1 - p))
    else:
        raise ValueError(case)
    return 1.0 - search_energy(prop, *comp) / search_energy(conv, *comp)


def cycle_improvement(entries: int) -> float:
    conv = CamConfig(entries, cscd=False, feedback=False, speculative=False)
    prop = CamConfig(entries)
    return 1.0 - cycle_time_ns(prop) / cycle_time_ns(conv)


class CamArray:
    """A stateful CAM routing LUT: stored tags + functional search + PPA.

    Tensors live on ``device`` (the CUDA device when None; pass
    ``device="cpu"`` for the CPU).  `write` returns a new array.
    """

    def __init__(self, cfg: CamConfig, tags=None, valid=None, device=None):
        self.cfg = cfg
        device = resolve_device(device)
        self.tags = (torch.zeros((cfg.entries, cfg.bits), dtype=torch.int32,
                                 device=device) if tags is None else
                     torch.as_tensor(tags, dtype=torch.int32, device=device))
        self.valid = (torch.zeros((cfg.entries,), dtype=torch.bool,
                                  device=device) if valid is None else
                      torch.as_tensor(valid, dtype=torch.bool, device=device))

    def write(self, entry: int, tag) -> "CamArray":
        tags, valid = self.tags.clone(), self.valid.clone()
        tags[entry] = torch.as_tensor(tag, dtype=torch.int32,
                                      device=tags.device)
        valid[entry] = True
        return CamArray(self.cfg, tags, valid, device=tags.device)

    def search(self, query):
        return search(self.tags, self.valid, query)

    def first_match(self, query):
        return first_match(self.tags, self.valid, query)


for _v in (
    CamVariant("conventional", cscd=False, feedback=False, speculative=False),
    CamVariant("cscd", cscd=True, feedback=False, speculative=False,
               settle_frac=SETTLE_FRAC[(False, False)]),
    CamVariant("cscd+fb", cscd=True, feedback=True, speculative=False,
               settle_frac=SETTLE_FRAC[(True, False)],
               match_charge_factor=0.6),
    CamVariant("cscd+ss", cscd=True, feedback=False, speculative=True,
               settle_frac=SETTLE_FRAC[(False, True)]),
    CamVariant("cscd+fb+ss", cscd=True, feedback=True, speculative=True,
               settle_frac=SETTLE_FRAC[(True, True)],
               match_charge_factor=0.6),
):
    if _v.name not in interface_registry.CAM_VARIANTS:
        interface_registry.register_cam_variant(_v.name, _v)
del _v
