"""llama3-8b — dense GQA decoder, 128k vocab.  [arXiv:2407.21783]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=128256,
    norm_kind="rmsnorm", mlp_kind="swiglu", rope_theta=500000.0,
    remat_policy="selective", fsdp_params=True, shard_kv_heads=False,
)

SMOKE = ModelConfig(
    name="llama3-smoke", family="dense",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=160, vocab_size=128,
    norm_kind="rmsnorm", mlp_kind="swiglu", rope_theta=500000.0,
    remat_policy="none", fsdp_params=False, attn_chunk_q=0,
)
