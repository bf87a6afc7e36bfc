"""internlm2-1.8b [dense]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544 (arXiv:2403.17297).  The port's copy of
`repro.configs.internlm2_1_8b`: 1.89 B parameters, 7.6 GB in float32."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-1.8b", family="dense",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
        head_dim=128, d_ff=8192, vocab=92544,
        rope_theta=1_000_000.0,
        param_dtype="float32", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-1.8b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab=128,
        param_dtype="float32", compute_dtype="float32",
    )
