"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H d_ff=1408 vocab=102400.

MLA kv_lora=512 without q-LoRA (lite variant); MoE 2 shared + 64 routed
top-6, first layer dense (d_ff 10944) (arXiv:2405.04434).  The port's
copy of `repro.configs.deepseek_v2_lite_16b`: 15.70 B parameters, 62.8 GB
in float32, which one 80 GB card holds."""

from repro_torch.models.config import MLAConfig, MoEConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe",
        n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
        head_dim=128, d_ff=1408, vocab=102400,
        mla=MLAConfig(kv_lora=512, q_lora=0, qk_nope_dim=128,
                      qk_rope_dim=64, v_head_dim=128),
        moe=MoEConfig(num_experts=64, num_shared=2, top_k=6,
                      d_expert=1408, first_k_dense=1, d_ff_dense=10944,
                      capacity_factor=1.25),
        param_dtype="float32", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b-smoke", family="moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=32, vocab=128,
        mla=MLAConfig(kv_lora=32, q_lora=0, qk_nope_dim=16,
                      qk_rope_dim=8, v_head_dim=16),
        moe=MoEConfig(num_experts=8, num_shared=2, top_k=2, d_expert=32,
                      first_k_dense=1, d_ff_dense=128),
        param_dtype="float32", compute_dtype="float32",
    )
