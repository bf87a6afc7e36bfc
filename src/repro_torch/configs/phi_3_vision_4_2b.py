"""phi-3-vision-4.2b [vlm]: 32L d_model=3072 32H (MHA kv=32) d_ff=8192
vocab=32064.  phi3-mini backbone + CLIP frontend STUB: input_specs
provide precomputed patch embeddings (B, 576, 1024) prepended to the
token stream (hf:microsoft/Phi-3-vision-128k-instruct).

The port's copy of `repro.configs.phi_3_vision_4_2b`: 3.82 B
parameters, 15.30 GB in float32."""

from repro_torch.models.config import FrontendConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b", family="vlm",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
        head_dim=96, d_ff=8192, vocab=32064,
        rope_theta=10_000.0,
        frontend=FrontendConfig(kind="vision", d_in=1024, max_prefix=576),
        param_dtype="float32", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab=128,
        frontend=FrontendConfig(kind="vision", d_in=32, max_prefix=8),
        param_dtype="float32", compute_dtype="float32",
    )
