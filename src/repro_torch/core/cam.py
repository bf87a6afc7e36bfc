"""CAM routing-memory PPA model (paper §IV), the behavioural half.

Port of the PPA layer of `repro.core.cam`: the registered circuit
variants, `CamConfig`, the cycle-time model and the per-search energy
model as a torch function.  The functional search half (`search`,
`CamArray`) is not ported yet (ROADMAP queue A item 8); the tick only
needs the decoded `RoutingIndex` gather.

Calibration constants are copied verbatim so both packages compute the
same numbers from the same inputs.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core import ppa
from repro_torch.interface import registry as interface_registry

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


def energy(cfg: CamConfig, n_match, n_mismatch):
    """Per-search model energy for float32 match/mismatch tensors.

    The torch form of `repro.core.cam._energy_jnp`: the same Python-float
    coefficients applied to the per-search match composition.
    """
    e_match, e_mm, fixed = energy_coefficients(cfg)
    return n_match * e_match + n_mismatch * e_mm + fixed


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
