"""qwen2-72b — 80-layer dense GQA decoder, QKV bias.  [arXiv:2407.10671; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=29568, vocab_size=152064, qkv_bias=True,
    norm_kind="rmsnorm", mlp_kind="swiglu", rope_theta=1000000.0,
    remat_policy="full", fsdp_params=True, shard_kv_heads=False,
    optimizer_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="qwen2-smoke", family="dense",
    num_layers=3, d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
    d_ff=192, vocab_size=128, qkv_bias=True,
    norm_kind="rmsnorm", mlp_kind="swiglu",
    remat_policy="none", fsdp_params=False, attn_chunk_q=0,
)
