"""Model configuration (port of ``repro/models/config.py``; dtype is a
``torch.dtype``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | rwkv | hybrid | encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    ssm_state: int = 0
    ssm_expand: int = 1
    sliding_window: int = 0          # 0 = full attention
    rope_theta: float = 1_000_000.0
    encoder_layers: int = 0
    encoder_seq: int = 0
    vision_prefix: int = 0
    mlp_type: str = "swiglu"         # swiglu | gelu
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16

    # quantized serving
    quantize_serve: bool = True
    quant_format: str = "w4a16_g128"
    group_size: int = 128
    w4a16_strategy: str = "auto"     # "auto" = planner; or a strategy name
    w4a16_plan: Any = None           # {"KxN": KernelPlan}

    # training
    remat: bool = True               # recompute each layer in backward
    attn_impl: str = "chunked"       # chunked (plain PyTorch, the JAX
                                     # trainer's attention) | flash (the
                                     # hand-written kernel, the deployment
                                     # value the launchers set)

    # multi-device serving: the rank's runtime.sharding.Layout (its heads,
    # its cut of the weights, the mesh's collectives); None on one device
    shard: Any = None
    # the SSM channels a mesh rank runs (its slice of ssm_expand * d_model,
    # d_model unchanged); None on one device
    ssm_inner: Optional[int] = None

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        if self.ssm_inner is not None:
            return self.ssm_inner
        return self.ssm_expand * self.d_model

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 256)

    @property
    def attn_free(self) -> bool:
        return self.family == "rwkv"

    def supports_long_context(self) -> bool:
        """True if the decode state is O(window) or O(1)."""
        return self.family in ("rwkv", "hybrid") or self.sliding_window > 0

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included, norms, biases,
        decay biases and SSM A/D left out, as in the JAX package): a moe
        layer holds E experts of 3·d·ff and a d×E router in place of the
        MLP, an rwkv layer six d×d time-mix and two channel-mix linears, a
        hybrid layer the SSM's four projections beside attention and the
        MLP, an encdec decoder layer a cross-attention beside them, and
        the encoder's layers attention and the MLP each."""
        d, ff, V = self.d_model, self.d_ff, self.padded_vocab
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        mlp = (3 if self.mlp_type == "swiglu" else 2) * d * ff
        if self.family == "moe":
            per_layer = attn + self.num_experts * 3 * d * ff \
                + d * self.num_experts
        elif self.family == "rwkv":
            per_layer = 6 * d * d + 2 * d * ff
        elif self.family == "hybrid":
            ssm = d * self.d_inner * 2 + d * 2 * self.ssm_state \
                + d * self.d_inner
            per_layer = attn + ssm + mlp
        elif self.family == "encdec":
            per_layer = 2 * attn + mlp
        else:
            per_layer = attn + mlp
        total = self.num_layers * per_layer + V * d
        if self.family == "encdec":
            total += self.encoder_layers * (attn + mlp)
        if not self.tie_embeddings:
            total += V * d
        return total

    def active_param_count(self) -> int:
        """Parameters one token touches: a moe token runs the top-k of
        its layer's experts."""
        if self.family != "moe":
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        dense_part = (self.param_count()
                      - self.num_layers * self.num_experts * 3 * d * ff)
        return dense_part \
            + self.num_layers * self.experts_per_token * 3 * d * ff
