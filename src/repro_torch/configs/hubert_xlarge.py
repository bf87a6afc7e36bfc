"""hubert-xlarge [audio]: 48L d_model=1280 16H (MHA) d_ff=5120 vocab=504.

Encoder-only masked-unit-prediction backbone (arXiv:2106.07447).  The
audio frontend is a STUB: input_specs provide precomputed frame
embeddings (B, T, 512).  No decode shapes (encoder).

The port's copy of `repro.configs.hubert_xlarge`: 1.26 B parameters,
5.04 GB in float32."""

from repro_torch.models.config import FrontendConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge", family="encoder",
        n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
        head_dim=80, d_ff=5120, vocab=504,
        encoder_only=True, act="gelu",
        frontend=FrontendConfig(kind="audio", d_in=512),
        param_dtype="float32", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge-smoke", family="encoder",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab=64,
        encoder_only=True, act="gelu",
        frontend=FrontendConfig(kind="audio", d_in=24),
        param_dtype="float32", compute_dtype="float32",
    )
