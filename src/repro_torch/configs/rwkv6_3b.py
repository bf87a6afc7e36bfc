"""rwkv6-3b [ssm]: 32L d_model=2560 (attn-free) d_ff=8960 vocab=65536.

Finch: data-dependent decay (arXiv:2404.05892).  40 heads of 64; heads
replicated over `model`, FFN + vocab TP (DESIGN.md §7.5).  Runs
long_500k (linear-time).

The port's copy of `repro.configs.rwkv6_3b`: 3.10 B parameters,
12.40 GB in float32."""

from repro_torch.models.config import ModelConfig, RWKVConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b", family="rwkv",
        n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
        head_dim=64, d_ff=8960, vocab=65536,
        rwkv=RWKVConfig(head_dim=64, lora_decay=64, lora_mix=32),
        param_dtype="float32", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b-smoke", family="rwkv",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=224, vocab=128,
        rwkv=RWKVConfig(head_dim=16, lora_decay=8, lora_mix=8),
        param_dtype="float32", compute_dtype="float32",
    )
