"""mamba2-780m — attention-free SSD (state-space duality) LM.

[arXiv:2405.21060]  48 layers, d_model 1536, ssm_state 128, head_dim 64,
expand 2 (d_inner 3072, 48 ssd heads), vocab 50280, tied embeddings.
vocab padded 50280 -> 50304 for 16-way TP divisibility (token ids stay
< 50280; padding rows are dead weights, standard practice).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, num_heads=1, num_kv_heads=1,
    d_ff=0, vocab_size=50304, tie_embeddings=True,  # padded from 50280
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    norm_kind="rmsnorm", remat_policy="selective", fsdp_params=True,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    num_layers=3, d_model=64, num_heads=1, num_kv_heads=1,
    d_ff=0, vocab_size=128, tie_embeddings=True,
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=16,
    norm_kind="rmsnorm", remat_policy="none", fsdp_params=False,
)
