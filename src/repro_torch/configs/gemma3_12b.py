"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144.  5:1 local(window 1024):global pattern, dual rope theta,
qk-norm, sandwich norms, tied embeddings (hf:google/gemma-3-12b-pt).  The
port's copy of `repro.configs.gemma3_12b`: 11.8 B parameters, about 47 GB
in float32."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b", family="dense",
        n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8,
        head_dim=256, d_ff=15360, vocab=262144,
        sliding_window=1024, local_global_ratio=5,
        rope_theta=1_000_000.0, rope_theta_local=10_000.0,
        qk_norm=True, post_norms=True, act="gelu",
        tie_embeddings=True, scan_group=6,
        param_dtype="float32", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b-smoke", family="dense",
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab=128,
        sliding_window=8, local_global_ratio=5,
        rope_theta=1_000_000.0, rope_theta_local=10_000.0,
        qk_norm=True, post_norms=True, act="gelu",
        tie_embeddings=True, scan_group=6,
        param_dtype="float32", compute_dtype="float32",
    )
