"""llama-3.2-vision-11b — dense decoder + gated cross-attention image layers
(copy of ``repro/configs/llama32_vision_11b.py``).

[hf:meta-llama/Llama-3.2-11B-Vision]  40 self-attn layers with a gated
cross-attention block every 5 layers (8 sites); the vision frontend is a
STUB providing precomputed patch embeddings (1600 tokens, d_model).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=128256,
    cross_attn_every=5, num_image_tokens=1600,
    norm_kind="rmsnorm", mlp_kind="swiglu", rope_theta=500000.0,
    remat_policy="selective", fsdp_params=True, shard_kv_heads=False,
)

SMOKE = ModelConfig(
    name="llama32v-smoke", family="vlm",
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=128,
    cross_attn_every=2, num_image_tokens=16,
    norm_kind="rmsnorm", mlp_kind="swiglu",
    remat_policy="none", fsdp_params=False, attn_chunk_q=0,
)
