"""olmo-1b — dense decoder with non-parametric LayerNorm.  [arXiv:2402.00838; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=8192, vocab_size=50304, tie_embeddings=True,
    norm_kind="nonparam_ln", mlp_kind="swiglu",
    remat_policy="selective", fsdp_params=False,
)

SMOKE = ModelConfig(
    name="olmo-smoke", family="dense",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=256, vocab_size=128, tie_embeddings=True,
    norm_kind="nonparam_ln", mlp_kind="swiglu",
    remat_policy="none", fsdp_params=False, attn_chunk_q=0,
)
