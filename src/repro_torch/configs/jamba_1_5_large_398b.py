"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536.  Mamba:attention 7:1 interleave (1 attn per
8-layer block), MoE 16 experts top-2 every other layer
(arXiv:2403.19887).  Runs long_500k (SSM-dominated; the 9 attention
layers use sequence-sharded KV decode).  bf16 params + moments.

The port's copy of `repro.configs.jamba_1_5_large_398b`: one 8-layer
block is 90.5 GB in bfloat16, more than one card holds; its first four
layers (23.02 B parameters, 46.04 GB) fit one."""

from repro_torch.models.config import MambaConfig, MoEConfig, ModelConfig

TRAIN_OVERRIDES = {"moment_dtype": "bfloat16"}


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid",
        n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
        head_dim=128, d_ff=24576, vocab=65536,
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
        attn_layer_period=8, attn_layer_offset=3,
        moe=MoEConfig(num_experts=16, top_k=2, d_expert=24576, every=2,
                      capacity_factor=1.25),
        scan_group=8,
        param_dtype="bfloat16", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b-smoke", family="hybrid",
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab=128,
        mamba=MambaConfig(d_state=8, d_conv=4, expand=2),
        attn_layer_period=8, attn_layer_offset=3,
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=64, every=2),
        scan_group=8,
        param_dtype="float32", compute_dtype="float32",
    )
