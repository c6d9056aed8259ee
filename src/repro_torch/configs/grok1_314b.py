"""grok-1-314b — 8-expert top-2 MoE decoder.  [hf:xai-org/grok-1]

8 experts < 16-way model axis -> TP-sharded experts (d_ff over "model"),
see DESIGN.md section 4.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=32768, vocab_size=131072,
    num_experts=8, num_experts_per_tok=2,
    norm_kind="rmsnorm", mlp_kind="swiglu",
    remat_policy="full", fsdp_params=True, shard_kv_heads=False,
    moe_sharding="tp", capacity_factor=1.25, optimizer_dtype="bfloat16",
    moe_groups=0,  # grouped dispatch (10.6x step-bound win, EXPERIMENTS §Perf)
)

SMOKE = ModelConfig(
    name="grok1-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=128,
    num_experts=4, num_experts_per_tok=2,
    norm_kind="rmsnorm", mlp_kind="swiglu",
    remat_policy="none", fsdp_params=False, moe_sharding="tp", attn_chunk_q=0,
)
