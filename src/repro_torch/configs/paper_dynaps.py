"""The paper's own workload: a DYNAPs-style multi-core SNN processor.

Port of `repro.configs.paper_dynaps`, with the same fields: 4 cores x 256
neurons, 11-bit CAM routing LUTs, HAT arbitration - the design point of
the paper's Tables I-III (N=256) and the 512x11 CAM (§IV-D).
`scaled_config` is a 16-core scale-up used by the examples."""

from repro_torch.core import cam
from repro_torch.interface.config import InterfaceConfig
from repro_torch.models.snn import SNNConfig


def config() -> SNNConfig:
    return SNNConfig(
        fabric=InterfaceConfig(
            cores=4, neurons_per_core=256, cam_entries_per_core=512,
            scheme="hier_tree", cam=cam.CamConfig(entries=512)),
        d_in=64, d_out=10, t_steps=32)


def scaled_config() -> SNNConfig:
    return SNNConfig(
        fabric=InterfaceConfig(
            cores=16, neurons_per_core=256, cam_entries_per_core=512,
            scheme="hier_tree", cam=cam.CamConfig(entries=512)),
        d_in=64, d_out=10, t_steps=32)


def smoke_config() -> SNNConfig:
    return SNNConfig(
        fabric=InterfaceConfig(
            cores=2, neurons_per_core=64, cam_entries_per_core=64,
            scheme="hier_tree", cam=cam.CamConfig(entries=64)),
        d_in=16, d_out=4, t_steps=8)
