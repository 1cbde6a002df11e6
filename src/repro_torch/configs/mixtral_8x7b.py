"""mixtral-8x7b — MoE with 8 experts, top-2, GQA over 8 KV heads and a
4096-token sliding window [arXiv:2401.04088; hf]. ``REDUCED`` is the JAX
package's test size."""
import dataclasses

import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32000, head_dim=128,
    num_experts=8, experts_per_token=2, sliding_window=4096,
    rope_theta=1_000_000.0,
)
REDUCED = dataclasses.replace(
    CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    head_dim=32, d_ff=256, vocab_size=512, num_experts=4,
    experts_per_token=2, sliding_window=16, dtype=torch.float32, remat=False)
