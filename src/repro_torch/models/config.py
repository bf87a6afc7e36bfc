"""Model configuration of the PyTorch port.

A copy of `repro.models.config` (the port imports nothing of the JAX
package): one dataclass describes every architecture family the JAX
package builds, and `layer_kind`, `layer_is_local`, `layer_is_moe` and
`scan_groups` resolve the per-layer pattern the same way, so the port's
parameter tree stacks layers in the same groups; `repro_torch.models.lm`
runs every family.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Sequence

Family = Literal["dense", "moe", "rwkv", "hybrid", "encoder", "vlm"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    num_shared: int = 0
    top_k: int = 1
    d_expert: int = 0            # per-expert FFN hidden dim
    capacity_factor: float = 1.25
    aux_loss_weight: float = 1e-2
    z_loss_weight: float = 1e-3
    every: int = 1               # MoE layer every `every` layers (jamba: 2)
    first_k_dense: int = 0       # leading dense layers (deepseek: 1)
    d_ff_dense: int = 0          # FFN dim of those dense layers
    quant_int8: bool = False     # weight-only int8 experts (serving)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora: int = 512
    q_lora: int = 0              # 0 = direct q projection (dsv2-lite)
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0             # 0 -> d_model // 16


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    lora_decay: int = 64         # rank of the data-dependent decay LoRA
    lora_mix: int = 32           # rank of the ddlerp token-shift LoRAs
    chunk: int = 16              # WKV chunk length (trades state traffic
                                 # for intra-chunk compute)


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend STUB: precomputed embeddings enter the backbone."""
    kind: Literal["none", "audio", "vision"] = "none"
    d_in: int = 0                # frame/patch embedding dim from the stub
    max_prefix: int = 0          # vision: image tokens prepended to text


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    rope_theta: float = 10_000.0
    rope_theta_local: float = 10_000.0   # gemma3 dual-theta
    qk_norm: bool = False
    sliding_window: int = 0              # 0 = always global
    local_global_ratio: int = 0          # gemma3: 5 local then 1 global
    norm_eps: float = 1e-6
    post_norms: bool = False             # gemma3 sandwich norms
    tie_embeddings: bool = False
    act: Literal["silu", "gelu", "relu2"] = "silu"
    encoder_only: bool = False
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    mamba: MambaConfig | None = None
    rwkv: RWKVConfig | None = None
    frontend: FrontendConfig = dataclasses.field(default_factory=FrontendConfig)
    attn_layer_period: int = 0           # jamba: 1 attention layer every N
    attn_layer_offset: int = 0
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # parallelism hints (resolved by parallel/sharding.py)
    attn_shard: Literal["heads", "sequence"] = "heads"
    scan_group: int = 1                  # layers per scan-group body
    serve_tp_only: bool = False          # serving: no FSDP dim on weights
    rwkv_pad_heads: int = 0              # pad WKV heads to shard over model
    ddlerp_bf16: bool = False            # RWKV: token-shift mix in bf16

    # ---- per-layer pattern ------------------------------------------------

    def layer_kind(self, i: int) -> str:
        """'attn' | 'mamba' | 'rwkv' - the sequence mixer of layer i."""
        if self.family == "rwkv":
            return "rwkv"
        if self.family == "hybrid":
            if self.attn_layer_period and i % self.attn_layer_period == self.attn_layer_offset:
                return "attn"
            return "mamba"
        return "attn"

    def layer_is_local(self, i: int) -> bool:
        """gemma3-style 5:1 local:global pattern."""
        if not self.local_global_ratio or not self.sliding_window:
            return False
        return (i % (self.local_global_ratio + 1)) != self.local_global_ratio

    def layer_is_moe(self, i: int) -> bool:
        if self.moe is None or self.moe.num_experts == 0:
            return False
        if i < self.moe.first_k_dense:
            return False
        return (i - self.moe.first_k_dense) % self.moe.every == 0 \
            if self.moe.every > 1 else True

    def scan_groups(self) -> Sequence[tuple[int, int]]:
        """(start, length) homogeneous layer groups for lax.scan stacking."""
        sig = [(self.layer_kind(i), self.layer_is_local(i), self.layer_is_moe(i))
               for i in range(self.n_layers)]
        g = self.scan_group
        groups = []
        i = 0
        while i < self.n_layers:
            # a group of g layers repeats while the g-periodic signature holds
            length = g
            while (i + length + g <= self.n_layers
                   and sig[i + length:i + length + g] == sig[i:i + g]):
                length += g
            groups.append((i, length))
            i += length
        return groups

    @property
    def n_rep(self) -> int:
        """GQA query-head replication factor."""
        return self.n_heads // max(self.n_kv_heads, 1)

    def supports_decode(self) -> bool:
        return not self.encoder_only

    def is_subquadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid / linear attention)."""
        return self.family in ("rwkv", "hybrid")
