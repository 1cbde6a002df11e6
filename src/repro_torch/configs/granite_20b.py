"""granite-20b — dense code model, llama architecture with one KV head
(48 query heads share it) [arXiv:2405.04324; hf]. Its K/V projections
are 6144 -> 128: K / N = 48, the paper's Split-K regime. ``REDUCED`` is
the JAX package's test size."""
import dataclasses

import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", family="dense",
    num_layers=52, d_model=6144, num_heads=48, num_kv_heads=1,
    d_ff=24576, vocab_size=49152, head_dim=128, rope_theta=10_000.0,
)
REDUCED = dataclasses.replace(
    CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=1,
    head_dim=32, d_ff=256, vocab_size=512, dtype=torch.float32, remat=False)
