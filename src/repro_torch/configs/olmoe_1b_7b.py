"""olmoe-1b-7b — fine-grained MoE: 64 experts, top-8, a small d_ff per
expert [arXiv:2409.02060; hf]. ``REDUCED`` is the JAX package's test
size."""
import dataclasses

import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1024, vocab_size=50304, head_dim=128,
    num_experts=64, experts_per_token=8, rope_theta=10_000.0,
)
REDUCED = dataclasses.replace(
    CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
    head_dim=32, d_ff=64, vocab_size=512, num_experts=8,
    experts_per_token=2, dtype=torch.float32, remat=False)
