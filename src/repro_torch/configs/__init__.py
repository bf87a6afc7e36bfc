"""Configurations of the PyTorch port: the paper's DYNAPs design point
(`paper_dynaps`) and the JAX package's LM architecture registry
(`get_config`, `get_smoke_config`, `train_overrides`).

The port runs all ten architectures: MLA attention with event-routed MoE
(``deepseek-v2-lite-16b``, ``deepseek-v2-236b``), dense GQA attention
(``internlm2-1.8b``, ``llama3.2-3b``, ``qwen3-32b`` with qk-norm,
``gemma3-12b`` with banded local layers), RWKV6 (``rwkv6-3b``), the
Mamba + attention + MoE hybrid (``jamba-1.5-large-398b``), and the audio
and vision frontend stubs (``hubert-xlarge``, ``phi-3-vision-4.2b``).
Three do not fit one 80 GB card at full depth: qwen3-32b (131 GB in
float32), jamba-1.5-large-398b (90.5 GB an 8-layer block in bfloat16)
and deepseek-v2-236b (472 GB in bfloat16).
"""

from __future__ import annotations

import importlib

ARCHS = {
    "hubert-xlarge": "hubert_xlarge",
    "rwkv6-3b": "rwkv6_3b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "gemma3-12b": "gemma3_12b",
    "internlm2-1.8b": "internlm2_1_8b",
    "qwen3-32b": "qwen3_32b",
    "llama3.2-3b": "llama3_2_3b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
}


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str):
    return _module(arch).config()


def get_smoke_config(arch: str):
    return _module(arch).smoke_config()


def train_overrides(arch: str) -> dict:
    """The arch's training overrides (``moment_dtype="bfloat16"`` for
    jamba-1.5-large-398b and deepseek-v2-236b), as the JAX registry's."""
    return getattr(_module(arch), "TRAIN_OVERRIDES", {})
