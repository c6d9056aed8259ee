"""qwen1.5-0.5b — dense decoder with QKV bias.  [hf:Qwen/Qwen1.5-0.5B]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", family="dense",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=2816, vocab_size=151936, tie_embeddings=True, qkv_bias=True,
    norm_kind="rmsnorm", mlp_kind="swiglu",
    remat_policy="selective", fsdp_params=False,
)

SMOKE = ModelConfig(
    name="qwen1.5-smoke", family="dense",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=96, vocab_size=256, tie_embeddings=True, qkv_bias=True,
    norm_kind="rmsnorm", mlp_kind="swiglu",
    remat_policy="none", fsdp_params=False, attn_chunk_q=0,
)
