"""zamba2-2.7b — Mamba2 backbone + one shared attention block (hybrid).

[arXiv:2411.15242; hf Zyphra/Zamba2-2.7B]  54 Mamba2 layers, d_model 2560,
shared attn block (32 MHA heads) applied every 6 layers (9 sites),
shared-MLP d_ff 10240, vocab 32000, ssm_state 64.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32, head_dim=80,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    hybrid_attn_every=6,
    norm_kind="rmsnorm", mlp_kind="swiglu", rope_theta=10000.0,
    remat_policy="selective", fsdp_params=True,
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=128,
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=16,
    hybrid_attn_every=2,
    norm_kind="rmsnorm", mlp_kind="swiglu", remat_policy="none",
    fsdp_params=False, attn_chunk_q=0,
)
