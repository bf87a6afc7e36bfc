"""Configurations of the PyTorch port: the paper's DYNAPs design point
(`paper_dynaps`) and the LM half of the JAX package's architecture
registry (`get_config`, `get_smoke_config`).

Of the registry's LM architectures the port runs DeepSeek-V2-Lite (MLA
attention, event-routed MoE).  The others are known by name and raise
`NotImplementedError` saying what they need: ROADMAP queue A item 12
(the LM scaffolding) carries the rest.
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

PORTED = ("deepseek-v2-lite-16b",)

# what each architecture that is not ported needs first
_NEEDS = {
    "hubert-xlarge": "the audio frontend and encoder-only GQA attention",
    "rwkv6-3b": "the RWKV6 time and channel mix",
    "deepseek-v2-236b": "its config (its MLA + MoE blocks are ported; "
                        "472 GB of bfloat16 parameters need more than "
                        "one card)",
    "gemma3-12b": "GQA attention with banded local layers",
    "internlm2-1.8b": "GQA attention",
    "qwen3-32b": "GQA attention",
    "llama3.2-3b": "GQA attention",
    "jamba-1.5-large-398b": "the Mamba mixer and GQA attention",
    "phi-3-vision-4.2b": "the vision frontend and GQA attention",
}


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    if arch not in PORTED:
        raise NotImplementedError(
            f"{arch} is not ported to repro_torch (ROADMAP queue A item 12, "
            f"the LM scaffolding): it needs {_NEEDS[arch]}; use the JAX "
            f"package `repro`")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str):
    return _module(arch).config()


def get_smoke_config(arch: str):
    return _module(arch).smoke_config()
