"""llama3-405b — dense frontier-scale model, GQA with 8 KV heads, a 128k
vocabulary [arXiv:2407.21783]. At full width it needs several cards: the
port runs it at ``REDUCED``, the JAX package's test size, only. The JAX
config's ``bf16_partials`` (bf16 sums of row-parallel partials across
devices) has no meaning on one card and is left out."""
import dataclasses

import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense",
    num_layers=126, d_model=16384, num_heads=128, num_kv_heads=8,
    d_ff=53248, vocab_size=128256, head_dim=128, rope_theta=500_000.0,
)
REDUCED = dataclasses.replace(
    CONFIG, num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
    head_dim=32, d_ff=512, vocab_size=512, dtype=torch.float32, remat=False)
