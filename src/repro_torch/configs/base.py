"""Model configuration of the port: a copy of ``repro/configs/base.py:
ModelConfig``, field for field, so that a JAX config converts with
``ModelConfig(**dataclasses.asdict(jax_cfg))``, and of its shape cells
(``ShapeConfig``, the dry run's input shapes). The port runs all six
families: dense, moe, ssm, hybrid, vlm and encdec.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


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

    def n_active_params(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if self.num_experts == 0:
            return self.n_params()
        d, f = self.d_model, self.d_ff
        dense_moe = self.num_experts * 3 * d * f
        active_moe = self.num_experts_per_tok * 3 * d * f
        return self.n_params() - self.num_layers * (dense_moe - active_moe)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell: what the dry run traces."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                       LONG_500K)


def shape_by_name(name: str) -> ShapeConfig:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}; have "
                   f"{[s.name for s in ALL_SHAPES]}")


def cell_is_applicable(cfg: ModelConfig, shape: ShapeConfig
                       ) -> Tuple[bool, str]:
    """Whether a (arch x shape) dry-run cell runs, and why not if
    skipped."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("long_500k requires sub-quadratic attention "
                       "(ssm/hybrid only)")
    return True, ""
