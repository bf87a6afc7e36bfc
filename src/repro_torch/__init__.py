"""repro_torch - the PyTorch/CUDA port of the `repro` core-interface
simulator, for NVIDIA Hopper (H100).

It mirrors the JAX package's layout (`core`, `interface`, `noc`,
`kernels`, `models`, `serve`) and imports nothing of it.  Sessions, the
SNN and the LM run on the GPU unless the caller passes ``device="cpu"``;
on CPU tensors every kernel wrapper takes its plain torch version.
"""

from repro_torch.interface import (  # noqa: F401
    Interface,
    InterfaceConfig,
    StepStats,
    params_from_numpy,
    random_connectivity,
)
