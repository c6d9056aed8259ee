"""seamless-m4t-large-v2 — encoder-decoder multimodal (audio) transformer
(copy of ``repro/configs/seamless_m4t_large_v2.py``).

[arXiv:2308.11596; hf]  24 encoder + 24 decoder layers, d_model 1024, 16 MHA
heads, d_ff 8192, vocab 256206 (padded to 256256 for 16-way TP
divisibility).  The audio frontend is a STUB: the caller provides
precomputed frame embeddings (``batch["frames"]``).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    num_layers=24, num_encoder_layers=24,
    d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=8192, vocab_size=256256, frontend_dim=1024,  # vocab padded from 256206
    encoder_is_audio=True,
    norm_kind="layernorm", mlp_kind="gelu",
    remat_policy="selective", fsdp_params=False,
)

SMOKE = ModelConfig(
    name="seamless-smoke", family="encdec",
    num_layers=2, num_encoder_layers=2,
    d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256, frontend_dim=32, encoder_is_audio=True,
    norm_kind="layernorm", mlp_kind="gelu",
    remat_policy="none", fsdp_params=False, attn_chunk_q=0,
)
