"""qwen3-32b [dense]: 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936.  Per-head qk RMSNorm (hf:Qwen/Qwen3-8B family).  The port's
copy of `repro.configs.qwen3_32b`: about 131 GB of float32 parameters,
more than one 80 GB card holds."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b", family="dense",
        n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8,
        head_dim=128, d_ff=25600, vocab=151936,
        qk_norm=True, rope_theta=1_000_000.0,
        param_dtype="float32", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
        head_dim=8, d_ff=128, vocab=128, qk_norm=True,
        param_dtype="float32", compute_dtype="float32",
    )
