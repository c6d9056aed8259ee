"""Model configuration of the port: a copy of ``repro/configs/base.py:
ModelConfig``, field for field, so that a JAX config converts with
``ModelConfig(**dataclasses.asdict(jax_cfg))``.

The port runs the families ``PORTED`` names (dense, moe, ssm, hybrid);
``vlm`` and ``encdec`` raise "not ported yet" (``require_ported``). Their
fields are kept all the same, so the two configs stay interchangeable.
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

    # memory knobs of the training path, which the port runs:
    # remat_policy wraps each layer (none | full | selective, see
    # models/transformer.py:_remat) and attn_chunk_q chunks the attention's
    # queries (models/attention.py:mha); the scoring forward's kernels
    # ignore both. scan_unroll is XLA-only (the port has no scan).
    remat_policy: str = "selective"
    scan_unroll: bool = False
    attn_chunk_q: int = 512

    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def is_encdec(self) -> bool:
        return self.num_encoder_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic archs (ssm / hybrid)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # every assigned arch has a decode path

    def n_params(self) -> int:
        """Analytic parameter count (the reference's formula)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim()
        qdim, kvdim = self.num_heads * hd, self.num_kv_heads * hd
        attn = d * qdim + 2 * d * kvdim + qdim * d
        if self.mlp_kind == "swiglu":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        if self.num_experts > 0:
            moe = self.num_experts * (3 * d * f) + d * self.num_experts
            if self.moe_dense_residual:
                moe += 3 * d * self.dense_residual_d_ff
            per_layer_ff = moe
        else:
            per_layer_ff = mlp
        ssm = 0
        if self.ssm_state > 0:
            dinner = self.ssm_expand * d
            nh = dinner // self.ssm_head_dim
            # in_proj (z,x,B,C,dt) + out_proj + conv + A,D
            ssm = d * (2 * dinner + 2 * self.ssm_state + nh) + dinner * d \
                + self.ssm_conv_width * (dinner + 2 * self.ssm_state) + 2 * nh
        if self.family in ("ssm", "hybrid"):
            per_layer = ssm  # the hybrid's shared block is counted below
        else:
            per_layer = attn + per_layer_ff
        total = self.num_layers * per_layer
        if self.family == "hybrid" and self.hybrid_attn_every:
            total += attn + 3 * d * f if f else attn  # one shared block
        if self.is_encdec:
            total += self.num_encoder_layers * (attn + per_layer_ff)
            total += self.num_layers * attn  # decoder cross-attention
        if self.cross_attn_every:
            n_cross = self.num_layers // self.cross_attn_every
            total += n_cross * (attn + per_layer_ff)
        total += v * d * (1 if self.tie_embeddings else 2)
        return total


# the families the port runs; vlm and encdec need modality-stub inputs,
# cross-attention and the encoder's caches, which are not ported yet
PORTED = ("dense", "moe", "ssm", "hybrid")


def require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet; the "
            f"PyTorch port runs families {PORTED}")
