"""arctic-480b — 128-expert top-2 MoE + dense residual FFN.

[hf:Snowflake/snowflake-arctic-base]  35 layers, d_model 7168, 56 GQA heads
(kv 8), expert d_ff 4864, dense-residual d_ff 4864, vocab 32000.
128 experts over the 16-way model axis -> expert parallelism (8/device).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8, head_dim=128,
    d_ff=4864, vocab_size=32000,
    num_experts=128, num_experts_per_tok=2,
    moe_dense_residual=True, dense_residual_d_ff=4864,
    norm_kind="rmsnorm", mlp_kind="swiglu",
    remat_policy="full", fsdp_params=True, shard_kv_heads=False,
    moe_sharding="ep", capacity_factor=1.0,
    moe_groups=0,  # grouped dispatch (3.7x step-bound win, EXPERIMENTS §Perf)
    param_dtype="bfloat16", optimizer_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="arctic-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=128,
    num_experts=8, num_experts_per_tok=2,
    moe_dense_residual=True, dense_residual_d_ff=96,
    norm_kind="rmsnorm", mlp_kind="swiglu",
    remat_policy="none", fsdp_params=False, moe_sharding="ep", attn_chunk_q=0,
)
