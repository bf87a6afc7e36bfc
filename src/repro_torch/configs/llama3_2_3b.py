"""llama3.2-3b [dense]: 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256 (hf:meta-llama/Llama-3.2-3B).  The port's copy of
`repro.configs.llama3_2_3b`.  ``attn_shard="sequence"`` is a hint for the
JAX package's mesh (24 heads don't divide its 16-way model axis); the
port runs on one device and reads no sharding hint."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b", family="dense",
        n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
        head_dim=128, d_ff=8192, vocab=128256,
        rope_theta=500_000.0, attn_shard="sequence",
        param_dtype="float32", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b-smoke", family="dense",
        n_layers=2, d_model=48, n_heads=6, n_kv_heads=2,
        head_dim=8, d_ff=128, vocab=128,
        attn_shard="sequence",
        param_dtype="float32", compute_dtype="float32",
    )
