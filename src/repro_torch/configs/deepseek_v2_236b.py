"""deepseek-v2-236b [moe]: 60L d_model=5120 128H d_ff=1536 vocab=102400.

MLA kv_lora=512 (+64 rope), q_lora=1536; MoE 2 shared + 160 routed top-6,
first layer dense (d_ff 12288) (arXiv:2405.04434).  The 160-expert top-6
dispatch routes through core/event_router (the paper-technique bridge).
bf16 params + bf16 AdamW moments (DESIGN.md §4 memory budget).

The port's copy of `repro.configs.deepseek_v2_236b`: 472 GB of
bfloat16 parameters need more than one card; its first two layers
(10.72 GB, 6.95 GB with int8 experts) fit one."""

from repro_torch.models.config import MLAConfig, MoEConfig, ModelConfig

TRAIN_OVERRIDES = {"moment_dtype": "bfloat16"}


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b", family="moe",
        n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
        head_dim=128, d_ff=1536, vocab=102400,
        mla=MLAConfig(kv_lora=512, q_lora=1536, qk_nope_dim=128,
                      qk_rope_dim=64, v_head_dim=128),
        moe=MoEConfig(num_experts=160, num_shared=2, top_k=6,
                      d_expert=1536, first_k_dense=1, d_ff_dense=12288,
                      capacity_factor=1.25),
        param_dtype="bfloat16", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b-smoke", family="moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=32, vocab=128,
        mla=MLAConfig(kv_lora=32, q_lora=48, qk_nope_dim=16,
                      qk_rope_dim=8, v_head_dim=16),
        moe=MoEConfig(num_experts=8, num_shared=2, top_k=2, d_expert=32,
                      first_k_dense=1, d_ff_dense=128),
        param_dtype="float32", compute_dtype="float32",
    )
