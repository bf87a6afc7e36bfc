"""`repro_torch.traffic` - registered spike-traffic scenarios.

See `repro_torch.traffic.scenarios` for the catalog and the registry
contract (the port of `repro.traffic`; named entries registered at
import, new scenarios plug in via `register_scenario`).
"""

from repro_torch.traffic.scenarios import (  # noqa: F401
    SCENARIOS,
    ScenarioSpec,
    expected_rate,
    generate,
    get_scenario,
    register_scenario,
    scenario_names,
    stream_seed,
)

__all__ = [
    "SCENARIOS",
    "ScenarioSpec",
    "expected_rate",
    "generate",
    "get_scenario",
    "register_scenario",
    "scenario_names",
    "stream_seed",
]
