"""hymba-1.5b — hybrid: parallel attention and Mamba (selective SSM) heads
in every layer, ssm_state 16, a 1024-token sliding window on the attention
half [arXiv:2411.13676; hf]. d_model 1600 is not a multiple of 128, so
the W4A16 leaves with K = 1600 quantize at group 64. ``REDUCED`` is the
JAX package's test size."""
import dataclasses

import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
    d_ff=5504, vocab_size=32001, head_dim=64, ssm_state=16, ssm_expand=2,
    sliding_window=1024, rope_theta=10_000.0,
)
REDUCED = dataclasses.replace(
    CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    head_dim=32, d_ff=256, vocab_size=512, ssm_state=8, ssm_expand=2,
    sliding_window=16, dtype=torch.float32, remat=False)
