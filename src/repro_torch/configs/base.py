"""Model configuration of the port: a copy of ``repro/configs/base.py:
ModelConfig``, field for field, so that a JAX config converts with
``ModelConfig(**dataclasses.asdict(jax_cfg))``.

The port runs ``family == "dense"`` only; the other families' fields are
kept so the two configs stay interchangeable.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str = "unnamed"
    family: str = "dense"  # dense | moe | ssm | hybrid | encdec | vlm

    # core transformer dims
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 2
    num_kv_heads: int = 2            # GQA: kv heads <= num_heads
    head_dim: int = 0                # 0 -> d_model // num_heads
    d_ff: int = 256
    vocab_size: int = 512

    # layer flavour knobs
    mlp_kind: str = "swiglu"         # swiglu | gelu
    norm_kind: str = "rmsnorm"       # rmsnorm | layernorm | nonparam_ln (olmo)
    qkv_bias: bool = False           # qwen-style attention bias
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    max_seq_len: int = 8192

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_dense_residual: bool = False
    dense_residual_d_ff: int = 0

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv_width: int = 4

    # hybrid (zamba2)
    hybrid_attn_every: int = 0

    # encoder-decoder (seamless)
    num_encoder_layers: int = 0
    encoder_is_audio: bool = True
    frontend_dim: int = 0

    # vlm (llama-3.2-vision)
    cross_attn_every: int = 0
    num_image_tokens: int = 0

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    optimizer_dtype: str = "float32"  # adam m/v dtype

    # distribution preferences (not used by the port yet)
    fsdp_params: bool = True
    moe_sharding: str = "ep"
    capacity_factor: float = 1.25
    moe_groups: int = 1
    shard_kv_heads: bool = True

    # remat and scan (XLA-only knobs; the port runs eagerly)
    remat_policy: str = "selective"
    scan_unroll: bool = False

    # attention implementation for the XLA path
    attn_chunk_q: int = 512

    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads


def require_dense(cfg: ModelConfig) -> None:
    """The port runs the dense family only (slice 1 of the port)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet; the "
            f"PyTorch port runs family 'dense'")
